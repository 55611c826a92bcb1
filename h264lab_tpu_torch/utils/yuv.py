"""Planar YUV 4:2:0 (I420) file I/O and frame-size name inference.

Reference equivalents: the driver's fread loop (`src/minih264e_test.c:578-584`)
and `guess_format_from_name` (`src/minih264e_test.c:288-329`).
"""

from __future__ import annotations

import os
import re

import numpy as np

# Named frame sizes from the reference driver
# (`src/minih264e_test.c:256-281`).
FRAME_SIZES = {
    "sqcif": (128, 96),
    "qcif": (176, 144),
    "svga": (800, 600),
    "4vga": (1280, 960),
    "sxga": (1280, 1024),
    "xga": (1024, 768),
    "vga": (640, 480),
    "qvga": (320, 240),
    "4cif": (704, 576),
    "4sif": (704, 480),
    "cif": (352, 288),
    "sif": (352, 240),
    "pal": (720, 576),
    "ntsc": (720, 480),
    "d1": (720, 480),
    "16cif": (1408, 1152),
    "16sif": (1408, 960),
    "720p": (1280, 720),
    "1080p": (1920, 1080),
    "4svga": (1600, 1200),
    "4xga": (2048, 1536),
    "16vga": (2560, 1920),
}


def guess_size_from_name(path: str, default=(352, 288)):
    """Infer (width, height) from `WxH` or a named size in the filename."""
    name = os.path.basename(path).lower()
    m = re.search(r"(\d{2,5})x(\d{2,5})", name)
    if m:
        return int(m.group(1)), int(m.group(2))
    for key in sorted(FRAME_SIZES, key=len, reverse=True):
        if key in name:
            return FRAME_SIZES[key]
    return default


class YuvReader:
    """Sequential I420 frame reader returning (y, u, v) uint8 planes."""

    def __init__(self, path: str, width: int, height: int):
        self.width = width
        self.height = height
        self.frame_bytes = width * height * 3 // 2
        self._f = open(path, "rb")

    def __iter__(self):
        return self

    def __next__(self):
        buf = self._f.read(self.frame_bytes)
        if len(buf) < self.frame_bytes:
            self._f.close()
            raise StopIteration
        w, h = self.width, self.height
        a = np.frombuffer(buf, dtype=np.uint8)
        y = a[:w * h].reshape(h, w)
        u = a[w * h:w * h * 5 // 4].reshape(h // 2, w // 2)
        v = a[w * h * 5 // 4:].reshape(h // 2, w // 2)
        return y, u, v

    def close(self):
        self._f.close()


class YuvWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        self._f.write(np.ascontiguousarray(y, dtype=np.uint8).tobytes())
        self._f.write(np.ascontiguousarray(u, dtype=np.uint8).tobytes())
        self._f.write(np.ascontiguousarray(v, dtype=np.uint8).tobytes())

    def close(self):
        self._f.close()


def read_yuv_frames(path: str, width: int, height: int, max_frames: int = 0):
    reader = YuvReader(path, width, height)
    for i, frame in enumerate(reader):
        if max_frames and i >= max_frames:
            reader.close()
            return
        yield frame
