"""A GIF89a writer in plain Python (the port's time-sweep videos).

The card's installation does not promise ``imageio`` or Pillow, so the
port writes its GIFs itself: every frame quantized to one fixed 256-colour
palette (3 bits of red, 3 of green, 2 of blue, each rounded to its nearest
level), LZW-coded as the GIF format specifies (variable code width from 9 to
12 bits, a clear code when the table is full), looping forever.
"""

from __future__ import annotations

import struct

import numpy as np

LEVELS = (8, 8, 4)  # red, green, blue


def palette() -> np.ndarray:
    """(256, 3) uint8: index = (r << 5) | (g << 2) | b over the levels."""
    i = np.arange(256)
    r, g, b = (i >> 5) & 7, (i >> 2) & 7, i & 3
    return np.stack([r * 255 // 7, g * 255 // 7, b * 255 // 3], -1).astype(np.uint8)


def quantize(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) uint8 palette indices."""
    f = frame.astype(np.int32)
    r = (f[..., 0] * 7 + 127) // 255
    g = (f[..., 1] * 7 + 127) // 255
    b = (f[..., 2] * 3 + 127) // 255
    return ((r << 5) | (g << 2) | b).astype(np.uint8)


def lzw_encode(indices: bytes, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a string of palette indices."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    state = {"bits": min_code_size + 1, "acc": 0, "n": 0, "free": clear + 2}
    out = bytearray()

    def emit(code):
        state["acc"] |= code << state["n"]
        state["n"] += state["bits"]
        while state["n"] >= 8:
            out.append(state["acc"] & 0xFF)
            state["acc"] >>= 8
            state["n"] -= 8

    table = {}
    emit(clear)
    ent = indices[0]
    for c in indices[1:]:
        key = (ent << 8) | c
        code = table.get(key)
        if code is not None:
            ent = code
            continue
        emit(ent)
        ent = c
        if state["free"] < 4096:
            table[key] = state["free"]
            state["free"] += 1
            # the decoder widens its codes once the table holds 2^bits entries
            if state["free"] > (1 << state["bits"]) and state["bits"] < 12:
                state["bits"] += 1
        else:
            emit(clear)
            table.clear()
            state["free"] = clear + 2
            state["bits"] = min_code_size + 1
    emit(ent)
    # the decoder adds one more entry on reading that last code
    if state["free"] >= (1 << state["bits"]) and state["bits"] < 12:
        state["bits"] += 1
    emit(eoi)
    if state["n"]:
        out.append(state["acc"] & 0xFF)
    return bytes(out)


def write_gif(path: str, frames: np.ndarray, delay_cs: int = 10):
    """Write (T, H, W, 3) uint8 frames as a looping GIF, ``delay_cs``
    hundredths of a second a frame."""
    frames = np.asarray(frames, np.uint8)
    T, H, W = frames.shape[:3]
    blob = bytearray(b"GIF89a")
    blob += struct.pack("<HHBBB", W, H, 0xF7, 0, 0)  # a global table of 256 colours
    blob += palette().tobytes()
    blob += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"  # loop
    for frame in frames:
        blob += b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00"
        blob += b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0)
        data = lzw_encode(quantize(frame).tobytes())
        blob.append(8)
        for i in range(0, len(data), 255):
            block = data[i:i + 255]
            blob.append(len(block))
            blob += block
        blob.append(0)
    blob.append(0x3B)
    with open(path, "wb") as f:
        f.write(bytes(blob))
