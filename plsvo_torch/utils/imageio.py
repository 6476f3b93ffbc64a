"""Minimal image codecs in numpy and the standard library (zlib, struct).

Decode: 8-bit greyscale PNG (colour type 0, bit depth 8, non-interlaced,
filters 0-4) and binary PGM (P5, maxval 255). Encode: 8-bit greyscale or
RGB PNG (filter 0 on every row) and P5 PGM. This is the port's last image
reader when neither its native loader nor cv2 nor PIL is available, and
its only PNG writer, so that datasets and annotated frames need no image
library.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    i = len(_PNG_SIG)
    while i + 8 <= len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        kind = data[i + 4:i + 8]
        yield kind, data[i + 8:i + 8 + n]
        i += 12 + n
        if kind == b"IEND":
            return


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, width: int, height: int) -> np.ndarray:
    """Undo the per-row PNG filters of a 1-byte-per-pixel image."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (width + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected "
                         f"{height * (width + 1)}")
    rows = rows.reshape(height, width + 1)
    out = np.zeros((height, width), np.uint8)
    prev = np.zeros(width, np.uint8)
    for y in range(height):
        ftype, f = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = f.copy()
        elif ftype == 1:  # Sub: running sum along the row, modulo 256
            cur = np.cumsum(f, dtype=np.uint8)
        elif ftype == 2:  # Up
            cur = f + prev
        elif ftype in (3, 4):  # Average, Paeth: each pixel needs its left one
            cur = np.zeros(width, np.uint8)
            left, up_left = 0, 0
            for x in range(width):
                up = int(prev[x])
                pred = ((left + up) >> 1 if ftype == 3
                        else _paeth(left, up, up_left))
                left = (int(f[x]) + pred) & 0xFF
                cur[x] = left
                up_left = up
        else:
            raise ValueError(f"PNG filter type {ftype}")
        out[y] = prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """(H, W) uint8 of an 8-bit greyscale, non-interlaced PNG."""
    if not data.startswith(_PNG_SIG):
        raise ValueError("not a PNG file")
    idat, hdr = [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 0, 0):
        raise ValueError(f"PNG bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}: only 8-bit greyscale, "
                         "non-interlaced is read")
    return _unfilter(zlib.decompress(b"".join(idat)), width, height)


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of an (H, W) greyscale or (H, W, 3) RGB uint8 image."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype, rowbytes = 0, img.shape[1]
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, rowbytes = 2, 3 * img.shape[1]
    else:
        raise ValueError(f"cannot write an image of shape {img.shape} as PNG")
    h, w = img.shape[:2]
    raw = np.zeros((h, rowbytes + 1), np.uint8)  # filter byte 0 per row
    raw[:, 1:] = img.reshape(h, rowbytes)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def _pgm_tokens(data: bytes, n: int):
    """The first n whitespace-separated header tokens (comments skipped)
    and the offset just after the single whitespace byte that ends them."""
    toks, i = [], 0
    while len(toks) < n:
        while i < len(data) and (data[i:i + 1].isspace() or data[i:i + 1] == b"#"):
            if data[i:i + 1] == b"#":
                while i < len(data) and data[i:i + 1] != b"\n":
                    i += 1
            else:
                i += 1
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        if j == i:
            raise ValueError("truncated PGM header")
        toks.append(data[i:j])
        i = j
    return toks, i + 1


def decode_pgm(data: bytes) -> np.ndarray:
    """(H, W) uint8 of a binary PGM (P5) with maxval 255."""
    (magic, w, h, maxval), off = _pgm_tokens(data, 4)
    if magic != b"P5" or int(maxval) != 255:
        raise ValueError(f"PGM {magic!r} with maxval {maxval!r}: only P5 with "
                         "maxval 255 is read")
    w, h = int(w), int(h)
    px = np.frombuffer(data, np.uint8, count=w * h, offset=off)
    return px.reshape(h, w).copy()


def encode_pgm(img: np.ndarray) -> bytes:
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    return f"P5\n{w} {h}\n255\n".encode() + img.tobytes()


def read_gray(path: str) -> np.ndarray:
    """Greyscale float32 image in [0, 255] of a PNG or PGM file this module
    decodes; raises ValueError for any other."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(_PNG_SIG):
        return decode_png(data).astype(np.float32)
    if data.startswith(b"P5"):
        return decode_pgm(data).astype(np.float32)
    raise ValueError(f"{path}: neither PNG nor binary PGM")


def write_png(path: str, img: np.ndarray):
    with open(path, "wb") as fh:
        fh.write(encode_png(img))
