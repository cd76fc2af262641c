"""DAVIS-style label colormap; the port's copy of
``cloth_splatting_tpu/utils/colormap.py`` (numpy only).

The reference hardcodes 252 RGB rows: the PASCAL-VOC bit-interleave palette
over indices 0..255 with the four grayscale rows (indices 0, 7, 56, 63)
removed, which is how it is generated here.
"""

from __future__ import annotations

import numpy as np


def voc_palette(n: int = 256) -> np.ndarray:
    """PASCAL-VOC label palette: [n, 3] float in [0, 1]."""
    c = np.arange(n, dtype=np.int64)
    r = np.zeros(n, np.int64)
    g = np.zeros(n, np.int64)
    b = np.zeros(n, np.int64)
    for j in range(8):
        r |= ((c >> 0) & 1) << (7 - j)
        g |= ((c >> 1) & 1) << (7 - j)
        b |= ((c >> 2) & 1) << (7 - j)
        c >>= 3
    return np.stack([r, g, b], axis=1) / 255.0


def _davis_colormap() -> np.ndarray:
    pal = voc_palette(256)
    gray = (pal[:, 0] == pal[:, 1]) & (pal[:, 1] == pal[:, 2])
    return pal[~gray]


#: [252, 3] float colormap, row for row the reference's ``colormap``.
colormap = _davis_colormap()
