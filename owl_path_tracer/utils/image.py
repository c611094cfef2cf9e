"""Image IO: PNG framebuffer output, LDR texture load, Radiance HDR env maps.

Parity notes vs the reference (``/root/reference/path_tracer/src/utils/image_buffer.cpp``):

* PNG read/write is a small zlib codec (no imaging library needed).
* ``write_png_rgba8`` stores the owl ``make_rgba`` quantization
  (``255.99 * clamp(c,0,1)``, device.cu:253) and the store-time vertical flip
  (device.cu:251) is done by the *integrator* handing us image-row-ordered data.
* ``load_texture_rgba8`` reproduces the LDR path incl. the vertical flip on
  load (image_buffer.cpp:49-55 / application.cpp:225-231).
* The reference loads ``environment.hdr`` through the same LDR 8-bit path
  (application.cpp:160, a real quality bug); we default to true float HDR via a
  pure-numpy Radiance ``.hdr`` codec and keep the LDR behaviour available as
  ``ldr_parity=True``.
"""
from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np


def quantize_rgba8(rgb: np.ndarray) -> np.ndarray:
    """f32 [...,3] linear -> uint8 [...,4] using owl's make_rgba rounding."""
    q = (np.clip(rgb, 0.0, 1.0) * 255.99).astype(np.uint8)
    a = np.full(q.shape[:-1] + (1,), 255, np.uint8)
    return np.concatenate([q, a], axis=-1)


# ── PNG codec (8-bit, non-interlaced), zlib + struct only ─────────────────

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (0 grey, 2 RGB, 3 palette, 4 grey+alpha,
# 6 RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunk(tag: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(tag + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def write_png_rgba8(path, rgba: np.ndarray):
    """rgba uint8 [H,W,4], row 0 = top of image (filter 0 on every row)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, c = rgba.shape
    assert c == 4, rgba.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, 4 * w)], axis=1)
    pathlib.Path(path).write_bytes(
        _PNG_SIGNATURE
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def write_png_rgb(path, rgb_f32: np.ndarray):
    write_png_rgba8(path, quantize_rgba8(rgb_f32))


def _png_unfilter(rows: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    out = np.empty(rows.shape, np.uint8)
    prev = np.zeros(rows.shape[1], np.int64)
    for y, f in enumerate(filters):
        x = rows[y].astype(np.int64)
        if f == 0:
            cur = x
        elif f == 1:  # Sub: running sum per channel
            cur = np.cumsum(x.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif f == 2:  # Up
            cur = (x + prev) % 256
        elif f in (3, 4):  # Average / Paeth: sequential along the row
            cur = np.zeros_like(x)
            for i in range(x.size):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if f == 3:
                    pred = (a + b) // 2
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (x[i] + pred) % 256
        else:
            raise ValueError(f"bad PNG filter type {f}")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """8-bit PNG (grey, grey+alpha, RGB, RGBA or palette) -> uint8 [H,W,4]."""
    data = pathlib.Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, trns = 8, [], None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if depth != 8 or interlace or ctype not in _PNG_CHANNELS:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); 8-bit non-interlaced only"
        )
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * ch)
    px = _png_unfilter(raw[:, 1:], raw[:, 0], ch).reshape(h, w, ch)
    if ctype == 3:
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            alpha[: len(trns)] = trns
        rgba = np.concatenate([palette, alpha[:, None]], axis=1)
        return rgba[px[..., 0]]
    if ch < 3:  # grey (+ alpha)
        px = np.concatenate([np.repeat(px[..., :1], 3, axis=-1), px[..., 1:]], axis=-1)
    if px.shape[-1] == 3:
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    return px


def load_texture_rgba8(path, flip_vertical: bool = True) -> np.ndarray:
    """LDR texture load with the reference's vertical flip; uint8 [H,W,4]."""
    img = read_png(path)
    if flip_vertical:
        img = img[::-1].copy()
    return img


# ── Radiance HDR (.hdr / RGBE) codec, pure numpy ───────────────────────────


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """uint8 [H,W,4] RGBE -> f32 [H,W,3]."""
    rgbe = rgbe.astype(np.int32)
    exp = rgbe[..., 3]
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 128 - 8)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """f32 [H,W,3] -> uint8 [H,W,4] RGBE."""
    maxc = rgb.max(axis=-1)
    mant, exp = np.frexp(maxc)
    scale = np.where(maxc > 1e-32, mant * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(maxc > 1e-32, exp + 128, 0).astype(np.uint8)
    return out


def read_hdr(path) -> np.ndarray:
    """Read a Radiance .hdr file -> linear f32 [H,W,3].

    Supports the common ``-Y H +X W`` orientation with adaptive RLE scanlines
    (and the uncompressed fallback).
    """
    data = pathlib.Path(path).read_bytes()
    # header ends at blank line
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError("bad hdr header")
    header = data[:pos].decode("latin-1")
    if "32-bit_rle_rgbe" not in header and not header.startswith("#?"):
        raise ValueError("not an RGBE hdr file")
    body = data[pos + 2 :]
    nl = body.find(b"\n")
    dims = body[:nl].decode("latin-1").split()
    if dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    buf = np.frombuffer(body[nl + 1 :], np.uint8)
    img = np.zeros((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        if w >= 8 and w < 32768 and p + 4 <= len(buf) and buf[p] == 2 and buf[p + 1] == 2:
            # adaptive RLE scanline
            p += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(buf[p])
                    p += 1
                    if count > 128:  # run
                        img[y, x : x + count - 128, c] = buf[p]
                        p += 1
                        x += count - 128
                    else:  # literal
                        img[y, x : x + count, c] = buf[p : p + count]
                        p += count
                        x += count
        else:
            flat = buf[p : p + w * 4].reshape(w, 4)
            img[y] = flat
            p += w * 4
    return _rgbe_to_float(img)


def write_hdr(path, rgb: np.ndarray):
    """Write linear f32 [H,W,3] as uncompressed Radiance .hdr."""
    h, w = rgb.shape[:2]
    header = f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode("latin-1")
    rgbe = _float_to_rgbe(np.asarray(rgb, np.float32))
    pathlib.Path(path).write_bytes(header + rgbe.tobytes())


def load_environment(path, ldr_parity: bool = False) -> np.ndarray:
    """Load an environment map -> linear f32 [H,W,3].

    ``ldr_parity=True`` mimics the reference bug: decode to 8-bit (tonemapped
    by stb for .hdr inputs) then normalize to [0,1], with vertical flip.
    """
    p = pathlib.Path(path)
    if not p.exists():
        return np.zeros((1, 1, 3), np.float32)
    if p.suffix.lower() == ".hdr" and not ldr_parity:
        img = read_hdr(p)
        return img[::-1].copy()  # reference flips on load (image_buffer.cpp:49)
    img = load_texture_rgba8(p)  # flips
    return (img[..., :3].astype(np.float32) / 255.0)
