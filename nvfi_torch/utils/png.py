"""A PNG codec in zlib and struct alone.

The port reads and writes its images without an imaging package (the card's
installation need not have one):

* ``write_png`` writes 8-bit RGB or RGBA, every row with filter 0 (None);
* ``read_png`` reads 8-bit greyscale, grey + alpha, RGB and RGBA images,
  non-interlaced, with any of the five row filters (None, Sub, Up, Average,
  Paeth), and returns the uint8 array in the layout ``np.asarray`` gives a
  Pillow image: (H, W) for greyscale, (H, W, channels) otherwise.

Other PNGs (palette, 16-bit, interlaced) raise ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
COLOUR_TYPE = {3: 2, 4: 6}  # channels -> colour type written


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Write a (H, W, 3) or (H, W, 4) uint8 array as an 8-bit RGB / RGBA PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in COLOUR_TYPE:
        raise ValueError(f"write_png takes (H, W, 3) or (H, W, 4) uint8, not "
                         f"{image.shape} {image.dtype}")
    h, w, c = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, COLOUR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one row's filter: ``row`` and ``prior`` (the decoded row above,
    zeros for the first) are int32 arrays of the row's bytes."""
    if kind == 0:
        return row
    if kind == 2:  # Up
        return (row + prior) & 0xFF
    n = row.shape[0]
    if kind == 1:  # Sub: a running sum over the pixels, channel by channel
        return np.cumsum(row.reshape(n // bpp, bpp), axis=0).reshape(n) & 0xFF
    if kind not in (3, 4):
        raise ValueError(f"PNG row filter {kind} is not one of 0-4")
    out = np.zeros(n + bpp, np.int32)  # bpp zeros on the left: the pixel before the first
    up = np.concatenate([np.zeros(bpp, np.int32), prior])
    for i in range(bpp, n + bpp, bpp):
        a, b = out[i - bpp:i], up[i:i + bpp]
        if kind == 3:  # Average
            pred = (a + b) >> 1
        else:  # Paeth
            pred = _paeth(a, b, up[i - bpp:i])
        out[i:i + bpp] = (row[i - bpp:i] + pred) & 0xFF
    return out[bpp:]


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced grey / grey-alpha / RGB / RGBA PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey, grey-alpha, RGB and RGBA "
                         f"PNGs are read (bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace})")
    c = CHANNELS[colour]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, want {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1).astype(np.int32)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        prior = _unfilter(int(raw[y, 0]), raw[y, 1:], prior, c)
        out[y] = prior
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)
