"""Live training viewer server; counterpart of
``cloth_splatting_tpu/utils/viewer.py`` (the same wire formats, so a client
of either package talks to both).

``init`` opens a non-blocking listening socket; the train loop polls it once
an iteration (``train/loop.py::_poll_viewer``): ``try_connect`` accepts a
waiting client, ``receive`` reads one request, ``send`` answers it, and an
error while answering drops the connection. Two codecs:

* ``protocol='json'`` (default): length-prefixed JSON and raw bytes.

    client -> server: 4-byte LE length + JSON {"world_view": [[...]x4],
        "full_proj": [[...]x4], "width": W, "height": H, "time": t,
        "do_training": bool, "keep_alive": bool, "scaling_modifier": 1.0}
    server -> client: 4-byte LE length + raw HxWx3 uint8 bytes.

* ``protocol='sibr'``: the reference's byte protocol, so that an unmodified
  SIBR remote viewer can connect.

    client -> server: 4-byte LE length + JSON {resolution_x, resolution_y,
        train, fov_y, fov_x, z_near, z_far, shs_python, rot_scale_python,
        keep_alive, scaling_modifier, view_matrix (16 floats),
        view_projection_matrix (16 floats)}; columns 1 and 2 of the view
    matrix and column 1 of the view-projection matrix are negated on
    receipt (OpenGL to splatting handedness).
    server -> client: raw HxWx3 bytes, then a 4-byte LE length and the
        ascii "verify" string (the training source path).
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional

import numpy as np

conn: Optional[socket.socket] = None
_listener: Optional[socket.socket] = None
protocol: str = "json"


def init(wish_host: str = "127.0.0.1", wish_port: int = 6009,
         wire_protocol: str = "json") -> None:
    global _listener, protocol
    protocol = wire_protocol
    _listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    _listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    _listener.bind((wish_host, wish_port))
    _listener.listen()
    _listener.settimeout(0)


def try_connect() -> None:
    """Accept a waiting client, if there is one; never blocks."""
    global conn
    if _listener is None:
        return
    try:
        conn, _ = _listener.accept()
        print("viewer connected")
        conn.settimeout(None)
    except OSError:
        pass


def _read_exact(n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        c = conn.recv(n - got)
        if not c:
            raise ConnectionError("viewer closed")
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def decode_sibr_message(msg: dict) -> tuple[Optional[dict], bool, bool, float]:
    """One SIBR viewer message as (camera dict or None, do_training,
    keep_alive, scaling_modifier)."""
    width = int(msg["resolution_x"])
    height = int(msg["resolution_y"])
    if width == 0 or height == 0:
        return None, True, True, 1.0
    wv = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    wv[:, 1] = -wv[:, 1]
    wv[:, 2] = -wv[:, 2]
    fp = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    fp[:, 1] = -fp[:, 1]
    cam = {
        "world_view": wv.tolist(),
        "full_proj": fp.tolist(),
        "width": width,
        "height": height,
        # SIBR cameras carry no scene time: the rest state unless given
        "time": float(msg.get("time", 0.0)),
    }
    return (cam, bool(msg.get("train", True)),
            bool(msg.get("keep_alive", True)),
            float(msg.get("scaling_modifier", 1.0)))


def receive() -> tuple[Optional[dict], bool, bool, float]:
    """(camera dict or None, do_training, keep_alive, scaling_modifier) of
    the next request."""
    (length,) = struct.unpack("<I", _read_exact(4))
    msg = json.loads(_read_exact(length))
    if protocol == "sibr":
        return decode_sibr_message(msg)
    cam = None
    if "world_view" in msg:
        cam = {
            "world_view": msg["world_view"],
            "full_proj": msg["full_proj"],
            "width": int(msg.get("width", 800)),
            "height": int(msg.get("height", 800)),
            "time": float(msg.get("time", 0.0)),
        }
    return (cam, bool(msg.get("do_training", True)),
            bool(msg.get("keep_alive", True)),
            float(msg.get("scaling_modifier", 1.0)))


def encode_sibr_reply(image_bytes: Optional[bytes], verify: str) -> bytes:
    """A SIBR reply: the raw image bytes (not length-prefixed: the client
    knows H * W * 3 from its request), then the LE length and ascii bytes of
    the verify string."""
    payload = image_bytes if image_bytes is not None else b""
    return payload + struct.pack("<I", len(verify)) + verify.encode("ascii")


def send(image_bytes: Optional[bytes], source_path: str = "") -> None:
    if protocol == "sibr":
        conn.sendall(encode_sibr_reply(image_bytes, source_path))
        return
    payload = image_bytes if image_bytes is not None else b""
    conn.sendall(struct.pack("<I", len(payload)) + payload)


def disconnect() -> None:
    global conn
    if conn is not None:
        try:
            conn.close()
        finally:
            conn = None


def shutdown() -> None:
    """Drop the client and close the listening socket."""
    global _listener
    disconnect()
    if _listener is not None:
        _listener.close()
        _listener = None
