"""Radiance RGBE (.hdr) codec.

The reference loads its HDR environment map natively through SOIL
(`SOIL_load_OGL_HDR_texture(data/textures/veranda_1k.hdr)`,
`Graphics.cpp:287` — the file itself is absent from the mount).  This module
is this framework's equivalent: decode .hdr → (H, W, 3) linear float32 for
`Scene.sky` equirect lookups.  A native C++ decoder (`native/hdr.cpp`) is
used when built; this pure-Python implementation is the fallback and the
format oracle (both are tested against each other and against an encode
round-trip).

Format: ASCII header (``#?RADIANCE``, ``FORMAT=32-bit_rle_rgbe``), blank
line, ``-Y H +X W`` resolution, then H scanlines, each either flat RGBE
quads or new-style RLE (leading ``0x02 0x02 hi lo``, four per-component
run-length streams).  Pixel decode: rgb = mantissa · 2^(e−136).
"""
from __future__ import annotations

import os

import numpy as np

_HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE → (..., 3) float32 linear."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e == 0.0, 0.0, np.exp2(e - 136.0))
    return rgbe[..., :3] * scale[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float32 → (..., 4) uint8 RGBE (round-to-nearest mantissa)."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    e = np.zeros_like(maxc, np.int32)
    nz = maxc >= 1e-32
    e[nz] = np.floor(np.log2(maxc[nz])).astype(np.int32) + 1
    scale = np.where(nz, np.exp2(-(e.astype(np.float32)) + 8.0), 0.0)
    mant = np.clip(np.round(rgb * scale[..., None]), 0, 255)
    # mantissa overflow after rounding (maxc exactly at a power of 2 edge)
    over = mant.max(axis=-1) > 255
    if np.any(over):
        e[over] += 1
        scale = np.where(nz, np.exp2(-(e.astype(np.float32)) + 8.0), 0.0)
        mant = np.clip(np.round(rgb * scale[..., None]), 0, 255)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = mant.astype(np.uint8)
    out[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    return out


def _decode_rle_scanline(data: bytes, pos: int, width: int):
    """New-style RLE scanline → ((W, 4) uint8, new position)."""
    comps = np.empty((4, width), np.uint8)
    for c in range(4):
        x = 0
        while x < width:
            count = data[pos]
            pos += 1
            if count > 128:  # run
                comps[c, x:x + count - 128] = data[pos]
                pos += 1
                x += count - 128
            else:  # literal
                comps[c, x:x + count] = np.frombuffer(
                    data, np.uint8, count, pos)
                pos += count
                x += count
    return comps.T.copy(), pos


def loads_hdr(data: bytes) -> np.ndarray:
    """Decode an in-memory .hdr file → (H, W, 3) linear float32."""
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    pos = 0
    # header: lines until the blank separator
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {res!r}")
    h, w = int(res[1]), int(res[3])

    rows = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        if (w >= 8 and w < 32768 and pos + 4 <= len(data)
                and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            rows[y], pos = _decode_rle_scanline(data, pos + 4, w)
        else:  # flat (or old-style) scanline
            flat = np.frombuffer(data, np.uint8, w * 4, pos)
            rows[y] = flat.reshape(w, 4)
            pos += w * 4
    return _rgbe_to_float(rows)


def load_hdr(path: str) -> np.ndarray:
    """Decode a .hdr file → (H, W, 3) linear float32 (native C++ decoder
    when built, Python fallback otherwise)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        from raymarchrenderer.io import native_bindings
        if native_bindings.available_hdr():
            return native_bindings.decode_hdr(data)
    except Exception:
        pass
    return loads_hdr(data)


def save_hdr(path: str, rgb: np.ndarray) -> None:
    """Encode (H, W, 3) linear float32 → flat (non-RLE) .hdr."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    rgbe = _float_to_rgbe(rgb)
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_env_map(path: str) -> np.ndarray:
    """Load an environment map by extension: .hdr (Radiance), .npy (raw
    linear float32), .png (sRGB-decoded to linear)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return load_hdr(path)
    if ext == ".npy":
        return np.asarray(np.load(path), np.float32)
    if ext == ".png":
        from raymarchrenderer.io.image import load_png
        return load_png(path)
    raise ValueError(f"unsupported env map format {ext}")
