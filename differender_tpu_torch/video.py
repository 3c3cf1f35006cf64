"""Video output (counterpart of ``differender_tpu/video.py``): the
reference's ``ti.VideoManager`` as Motion-JPEG in an AVI container, written
from scratch (RIFF/AVI is a simple chunk format; every frame is a
PIL-encoded JPEG), with the same frame-push API.  Frames may be tensors on
any device or arrays: each comes to the host first and is converted there
as the JAX package converts it, so the same frames give the same bytes.
PIL is imported when a frame is written.
"""
from __future__ import annotations

import io
import struct
from typing import Optional

import numpy as np

from .interop import to_numpy


def _to_u8_rgb(frame) -> np.ndarray:
    """(H, W, 3|4) float [0,1] or uint8 -> (H, W, 3) uint8, on the host."""
    a = to_numpy(frame)
    if a.ndim != 3 or a.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) frame, got {a.shape}")
    a = a[..., :3]
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(a)


class VideoWriter:
    """Stream frames into an MJPEG .avi file.

    Mirrors ``ti.VideoManager``'s usage: construct, ``write_frame`` per
    iteration, ``close`` (or use as a context manager)::

        with VideoWriter("out/opt.avi", fps=24) as vw:
            for step in ...:
                vw.write_frame(image)   # (H, W, 3|4) float [0,1] or uint8,
                                        # a tensor or an array

    All frames must share one resolution (set by the first frame).
    """

    def __init__(self, path: str, fps: int = 24, quality: int = 90):
        if not path.endswith(".avi"):
            path += ".avi"
        self.path = path
        self.fps = int(fps)
        self.quality = int(quality)
        self._frames: list[bytes] = []
        self._size: Optional[tuple] = None

    def write_frame(self, frame):
        from PIL import Image
        rgb = _to_u8_rgb(frame)
        if self._size is None:
            self._size = rgb.shape[:2]
        elif rgb.shape[:2] != self._size:
            raise ValueError(
                f"frame size {rgb.shape[:2]} != first frame {self._size}")
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="JPEG", quality=self.quality)
        self._frames.append(buf.getvalue())

    @property
    def n_frames(self) -> int:
        return len(self._frames)

    def close(self):
        if self._size is None:
            raise ValueError("no frames written")
        if not self._frames:
            raise ValueError(f"{self.path}: already closed (no frames "
                             "buffered); create a new VideoWriter")
        h, w = self._size
        fps = max(self.fps, 1)

        def chunk(fourcc: bytes, payload: bytes) -> bytes:
            pad = b"\x00" if len(payload) % 2 else b""
            return fourcc + struct.pack("<I", len(payload)) + payload + pad

        def lst(kind: bytes, payload: bytes) -> bytes:
            body = kind + payload
            pad = b"\x00" if len(body) % 2 else b""
            return b"LIST" + struct.pack("<I", len(body)) + body + pad

        max_bytes = max(len(f) for f in self._frames)
        avih = struct.pack(
            "<IIIIIIIIIIIIII",
            1_000_000 // fps,            # dwMicroSecPerFrame
            max_bytes * fps,             # dwMaxBytesPerSec
            0,                           # padding granularity
            0x10,                        # AVIF_HASINDEX
            len(self._frames), 0, 1,     # frames, initial, streams
            max_bytes, w, h, 0, 0, 0, 0)
        strh = struct.pack(
            "<4s4sIHHIIIIIIIIhhhh",
            b"vids", b"MJPG", 0, 0, 0, 0,
            1, fps,                      # scale, rate -> fps
            0, len(self._frames), max_bytes,
            0xFFFFFFFF & -1, 0,          # quality (-1 default), samplesize
            0, 0, w, h)                  # rcFrame
        strf = struct.pack(
            "<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3,
            0, 0, 0, 0)
        hdrl = lst(b"hdrl", chunk(b"avih", avih)
                   + lst(b"strl", chunk(b"strh", strh)
                         + chunk(b"strf", strf)))

        movi_chunks = []
        index = []
        offset = 4                       # relative to 'movi' fourcc
        for f in self._frames:
            c = chunk(b"00dc", f)
            movi_chunks.append(c)
            index.append(struct.pack("<4sIII", b"00dc", 0x10, offset,
                                     len(f)))
            offset += len(c)
        movi = lst(b"movi", b"".join(movi_chunks))
        idx1 = chunk(b"idx1", b"".join(index))

        riff_body = b"AVI " + hdrl + movi + idx1
        with open(self.path, "wb") as out:
            out.write(b"RIFF" + struct.pack("<I", len(riff_body))
                      + riff_body)
        self._frames = []

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self._frames:
            self.close()
        return False


def save_video(frames, path: str, fps: int = 24, quality: int = 90) -> str:
    """One-shot helper: encode an iterable of frames to ``path`` (.avi)."""
    vw = VideoWriter(path, fps=fps, quality=quality)
    for f in frames:
        vw.write_frame(f)
    vw.close()
    return vw.path
