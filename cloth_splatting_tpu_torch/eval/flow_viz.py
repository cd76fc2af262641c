"""Tracked-point and trajectory overlays on rendered frames, and the
optical-flow colour wheel; the port's copy of
``cloth_splatting_tpu/eval/flow_viz.py`` (numpy; ``draw_tracks`` imports
``cv2`` when called).

Tracked points are drawn where their camera-space depth is not occluded by
the rendered depth map, and short trajectory tails connect consecutive
frames. Colours follow the DAVIS colormap.
"""

from __future__ import annotations

import numpy as np


def davis_palette(n: int) -> np.ndarray:
    """First n colors of the DAVIS label palette (uint8 [n, 3]; the
    reference's utils/colormap.py array, cycled — render.py:152 convention
    ``colormap[arange(n) % len(colormap)]``)."""
    from cloth_splatting_tpu_torch.utils.colormap import colormap

    base = (colormap * 255).astype(np.uint8)
    return base[np.arange(n) % len(base)]


def occlusion_mask(projections: np.ndarray, point_depth: np.ndarray,
                   depth_map: np.ndarray, tol: float = 0.05) -> np.ndarray:
    """Visible-point mask: the point's depth must be within ``tol`` of the
    rendered depth at its pixel (reference get_mask, render.py:95-121)."""
    h, w = depth_map.shape[-2:]
    x = np.clip(np.round(projections[:, 0]).astype(int), 0, w - 1)
    y = np.clip(np.round(projections[:, 1]).astype(int), 0, h - 1)
    d_at = depth_map.reshape(h, w)[y, x]
    on_screen = ((projections[:, 0] >= 0) & (projections[:, 0] < w)
                 & (projections[:, 1] >= 0) & (projections[:, 1] < h))
    return on_screen & (point_depth <= d_at + tol)


def draw_tracks(image: np.ndarray, track_projections: list[np.ndarray],
                visible: np.ndarray, radius: int = 2,
                tail: int = 4) -> np.ndarray:
    """Draw tracked points + trajectory tails onto an HxWx3 uint8 image.

    Args:
        track_projections: list over time of [M, 2] pixel positions
            (last entry = current frame).
        visible: [M] bool visibility at the current frame.
    """
    import cv2

    img = image.copy()
    colors = davis_palette(track_projections[-1].shape[0])
    current = track_projections[-1]
    for t in range(max(len(track_projections) - tail, 0),
                   len(track_projections) - 1):
        a, b = track_projections[t], track_projections[t + 1]
        for m in range(current.shape[0]):
            if visible[m]:
                cv2.line(img, tuple(np.round(a[m]).astype(int)),
                         tuple(np.round(b[m]).astype(int)),
                         colors[m].tolist(), 1, cv2.LINE_AA)
    for m in range(current.shape[0]):
        if visible[m]:
            cv2.circle(img, tuple(np.round(current[m]).astype(int)), radius,
                       colors[m].tolist(), -1, cv2.LINE_AA)
    return img


def make_color_wheel() -> np.ndarray:
    """Middlebury optical-flow color wheel ([55, 3] float in [0, 1]) — the
    standard Baker et al. segment layout the reference's vendored RAFT helper
    uses (scripts/utils/flow_viz.py): RY 15, YG 6, GC 4, CB 11, BM 13, MR 6
    linear transitions."""
    segments = [15, 6, 4, 11, 13, 6]
    anchors = np.asarray([
        [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], [1, 0, 1],
        [1, 0, 0],
    ], np.float64)
    rows = []
    for i, n in enumerate(segments):
        t = (np.arange(n) / n)[:, None]
        rows.append(anchors[i] * (1 - t) + anchors[i + 1] * t)
    return np.concatenate(rows, axis=0)


def flow_to_image(flow_uv: np.ndarray, clip_flow: float | None = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """[H, W, 2] flow -> uint8 [H, W, 3] color-wheel visualization
    (reference scripts/utils/flow_viz.py:109 contract: normalize by the max
    radius, hue from angle, saturation from radius)."""
    u = flow_uv[..., 0].astype(np.float64)
    v = flow_uv[..., 1].astype(np.float64)
    if clip_flow is not None:
        u = np.clip(u, 0, clip_flow)
        v = np.clip(v, 0, clip_flow)
    rad_max = float(np.sqrt(u * u + v * v).max())
    u = u / (rad_max + 1e-5)
    v = v / (rad_max + 1e-5)

    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = (1 - f) * wheel[k0] + f * wheel[k1]
    small = rad[..., None] <= 1
    col = np.where(small, 1 - rad[..., None] * (1 - col), col * 0.75)
    img = np.floor(255 * col).astype(np.uint8)
    if convert_to_bgr:
        img = img[..., ::-1]
    return img
