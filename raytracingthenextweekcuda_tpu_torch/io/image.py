"""PNG/PPM image output (numpy copy of
raytracingthenextweekcuda_tpu/io/image.py).

Replaces Canvas::writeToPNG / writeToPPM (Canvas.h:108-154, stb_image_write).
The PNG encoder is a dependency-free minimal implementation (zlib + struct):
8-bit RGB, no interlace — all this framework needs.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def png_bytes(image: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 array (row 0 = top) as PNG bytes."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = image.shape
    assert c == 3, "png_bytes expects RGB"
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    # Filter byte 0 (None) per scanline.
    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", header)
        + _png_chunk(b"IDAT", zlib.compress(raw, 6))
        + _png_chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array (row 0 = top) as a PNG file."""
    with open(path, "wb") as f:
        f.write(png_bytes(image))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own files (8-bit RGB, filter 0/1/2/3/4)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", payload[:10])
            assert depth == 8 and color == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        filt = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8
        ).astype(np.int32)
        if filt == 0:
            cur = line
        elif filt == 2:  # Up
            cur = (line + prev) & 0xFF
        else:  # Sub / Average / Paeth need sequential reconstruction
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - 3] if i >= 3 else 0
                b = prev[i]
                c = prev[i - 3] if i >= 3 else 0
                if filt == 1:
                    pred = a
                elif filt == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, 3)


def write_ppm(path: str, image: np.ndarray) -> None:
    """ASCII P3 PPM, matching Canvas::writeToPPM's format (Canvas.h:108-139)."""
    image = np.asarray(image, dtype=np.uint8)
    h, w, _ = image.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        flat = image.reshape(-1, 3)
        f.write("\n".join(f"{r} {g} {b}" for r, g, b in flat))
        f.write("\n")
