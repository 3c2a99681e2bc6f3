"""PNG and GIF writers and a bare line plot in numpy and zlib, for
machines without imageio or matplotlib (the port's GPU machine has
neither): the overlay video falls back to :func:`write_gif`, the
checkpoint tools' diagnostic plot to :func:`plot_png`."""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Tuple

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> str:
    """Writes an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], 1)     # filter 0 a row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
    return path


# GIF: a fixed 3-3-2 palette and LZW codes that never grow past 9 bits (a
# clear code before every run of _RUN literals keeps the decoder's table
# below 512 entries), so the encoder is a few vectorised numpy lines
_RUN = 250
_CLEAR, _EOI, _BITS = 256, 257, 9


def _palette() -> bytes:
    i = np.arange(256)
    rgb = np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                    (i & 3) * 255 // 3], 1)
    return rgb.astype(np.uint8).tobytes()


def _lzw_blocks(index: np.ndarray) -> bytes:
    n = index.size
    runs = -(-n // _RUN)
    codes = np.full((runs, _RUN + 1), -1, np.int64)
    codes[:, 0] = _CLEAR
    codes[:, 1:].flat[:n] = index
    codes = np.append(codes[codes >= 0], _EOI)
    bits = (codes[:, None] >> np.arange(_BITS)) & 1
    data = np.packbits(bits.astype(np.uint8).ravel(),
                       bitorder="little").tobytes()
    out = [bytes([8])]                                 # LZW minimum code size
    for k in range(0, len(data), 255):
        block = data[k:k + 255]
        out.append(bytes([len(block)]) + block)
    out.append(b"\x00")
    return b"".join(out)


def write_gif(path: str, frames: Sequence[np.ndarray], fps: int = 50) -> str:
    """Writes (H, W, 3) uint8 frames as a looping GIF (3-3-2 colours)."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w, _ = frames[0].shape
    delay = max(1, round(100 / fps))                   # hundredths of a second
    with open(path, "wb") as f:
        f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0))
        f.write(_palette())
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        for fr in frames:
            fr = fr.astype(np.int64)
            index = ((fr[..., 0] >> 5) << 5) | ((fr[..., 1] >> 5) << 2) | \
                (fr[..., 2] >> 6)
            f.write(b"\x21\xf9\x04\x00" + struct.pack("<H", delay)
                    + b"\x00\x00")
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            f.write(_lzw_blocks(index.ravel()))
        f.write(b"\x3b")
    return path


def _line(img, x, y, color, width: int = 2):
    """Draws the polyline through pixel coordinates (x, y)."""
    h, w, _ = img.shape
    for x0, y0, x1, y1 in zip(x[:-1], y[:-1], x[1:], y[1:]):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        xs = np.rint(np.linspace(x0, x1, n)).astype(int)
        ys = np.rint(np.linspace(y0, y1, n)).astype(int)
        for d in range(width):
            img[np.clip(ys + d, 0, h - 1), np.clip(xs, 0, w - 1)] = color


def plot_png(path: str, series: Sequence[Tuple[Sequence[float],
                                               Tuple[int, int, int]]],
             width: int = 910, height: int = 650) -> str:
    """Stacked panels, one series each (values, RGB colour), every panel
    scaled to its own range, on a light grid; no text."""
    img = np.full((height, width, 3), 255, np.uint8)
    ph, m = height // len(series), 30
    for k, (values, color) in enumerate(series):
        v = np.asarray(values, np.float64)
        v = np.where(np.isfinite(v), v, 0.0)
        top, bottom, left, right = k * ph + m, (k + 1) * ph - m, m, width - m
        for t in np.linspace(top, bottom, 5):
            img[int(t), left:right] = (228, 230, 234)
        img[top:bottom, left] = img[bottom, left:right] = (150, 150, 150)
        lo, hi = float(v.min()), float(v.max())
        span = hi - lo if hi > lo else 1.0
        x = left + np.arange(len(v)) * (right - left) / max(len(v) - 1, 1)
        y = bottom - (v - lo) / span * (bottom - top)
        _line(img, x, y, color)
    return write_png(path, img)
