"""PNG reading and writing (counterpart of ``bpldenoising_tpu.data.png_io``).

The built C++ codec (:mod:`.native`, compiled at first use) reads and
writes; where it cannot be built (no ``g++`` or no ``zlib.h``) the pure
Python codec of this module, on the standard library's ``zlib`` and numpy,
does.  ``native.backend`` says which one runs.  Both take the same files:
the header is checked here before either decodes, and a decode or encode
error of the built codec raises (``OSError``) without a retry in Python.

Reads non-interlaced PNGs with all five scanline filter types: grayscale
of bit depth 1, 2, 4, 8 or 16 and RGB of depth 8 or 16 (the bundled
datasets are 8-bit grayscale and 8-bit RGB).  A sample v
of depth d scales to float64 in [0, 1] as ``v * (1.0 / (2**d - 1))``, as
the JAX package's native codec does.  Writes 8-bit grayscale and 8-bit
RGB (from planar (3, rows, cols) arrays) with the native codec's
quantisation: a value clipped to [0, 1] (NaN to 0) becomes
``uint8(v·255 + 0.5)``; every scanline takes filter type 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native

__all__ = ["read_png_gray", "read_png_color", "write_png_gray",
           "write_png_color"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels per pixel of each color type read: gray, RGB
_CHANNELS = {0: 1, 2: 3}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return


def _paeth(a: int, b: int, c: int) -> int:
    """The Paeth predictor of left ``a``, above ``b`` and upper-left ``c``."""
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, row_bytes: int,
              bpp: int) -> np.ndarray:
    """Undo the per-scanline filters; ``bpp`` is the filter's byte step
    (bytes per pixel, at least 1).  Sub, Average and Paeth depend on the
    byte just decoded to the left, so they run as loops over Python ints
    on bytearrays (numpy element access is slower)."""
    stride = row_bytes + 1
    out = bytearray(height * row_bytes)
    prev = bytearray(row_bytes)
    for r in range(height):
        ftype = raw[r * stride]
        line = raw[r * stride + 1:(r + 1) * stride]
        if ftype == 0:
            cur = bytearray(line)
        elif ftype == 2:
            cur = bytearray((x + up) & 0xFF for x, up in zip(line, prev))
        elif ftype in (1, 3, 4):
            cur = bytearray(row_bytes)
            for c in range(row_bytes):
                left = cur[c - bpp] if c >= bpp else 0
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + prev[c]) >> 1
                else:
                    pred = _paeth(left, prev[c],
                                  prev[c - bpp] if c >= bpp else 0)
                cur[c] = (line[c] + pred) & 0xFF
        else:
            raise ValueError(f"PNG filter type {ftype} is invalid")
        out[r * row_bytes:(r + 1) * row_bytes] = cur
        prev = cur
    return np.frombuffer(bytes(out), np.uint8).reshape(height, row_bytes)


def _check_header(path: str, header, gray_only: bool) -> None:
    """Refuse what the readers do not take: ``gray_only`` every color
    type but 0, and any depth, color type or interlace not listed in the
    module's docstring."""
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    _, _, depth, color, _, _, interlace = header
    if gray_only and color != 0:
        raise NotImplementedError(
            f"{path}: read_png_gray reads grayscale PNGs only (color type "
            f"{color}); read_png_color reads color")
    depths = (1, 2, 4, 8, 16) if color == 0 else (8, 16)
    if color not in _CHANNELS or depth not in depths or interlace != 0:
        raise NotImplementedError(
            f"{path}: only non-interlaced grayscale and RGB PNGs are read "
            f"(bit depth {depth}, color type {color}, interlace "
            f"{interlace})")


def _header(path: str, gray_only: bool) -> None:
    """Check the signature and the IHDR chunk, which a PNG puts first."""
    with open(path, "rb") as fh:
        head = fh.read(len(_SIGNATURE) + 8 + 13)
    if not head.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header = None
    if len(head) == 29 and head[8:16] == struct.pack(">I", 13) + b"IHDR":
        header = struct.unpack(">IIBBBBB", head[16:29])
    _check_header(path, header, gray_only)


def _decode(path: str, gray_only: bool):
    """→ (samples, color type, depth), the samples as int64 (rows, cols,
    channels); ``gray_only`` refuses every color type but 0."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    _check_header(path, header, gray_only)
    width, height, depth, color, _, _, _ = header
    channels = _CHANNELS[color]
    row_bytes = (width * channels * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (row_bytes + 1):
        raise ValueError(f"{path}: image data has the wrong length")
    data = _unfilter(raw, height, row_bytes,
                     max(1, channels * depth // 8)).astype(np.int64)
    if depth == 16:
        samples = data[:, 0::2] * 256 + data[:, 1::2]
    elif depth == 8:
        samples = data
    else:
        per_byte = 8 // depth
        shifts = 8 - depth * (1 + np.arange(per_byte))
        bits = (data[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = bits.reshape(height, -1)[:, :width]
    return samples.reshape(height, width, channels), color, depth


def read_png_gray_python(path: str) -> np.ndarray:
    """:func:`read_png_gray` in pure Python."""
    samples, _, depth = _decode(path, gray_only=True)
    return samples[:, :, 0].astype(np.float64) * (1.0 / ((1 << depth) - 1))


def read_png_color_python(path: str) -> np.ndarray:
    """:func:`read_png_color` in pure Python."""
    samples, _, depth = _decode(path, gray_only=False)
    planes = np.moveaxis(samples.astype(np.float64)
                         * (1.0 / ((1 << depth) - 1)), -1, 0)
    return np.ascontiguousarray(np.broadcast_to(planes,
                                                (3,) + planes.shape[1:]))


def read_png_gray(path: str) -> np.ndarray:
    """Read a grayscale PNG as a float64 array in [0, 1]."""
    if native.library() is None:
        return read_png_gray_python(path)
    _header(path, gray_only=True)
    return native.read_png_gray_native(path)


def read_png_color(path: str) -> np.ndarray:
    """Read an RGB PNG as a planar (3, rows, cols) float64 array in
    [0, 1]; a grayscale source replicates its channel."""
    if native.library() is None:
        return read_png_color_python(path)
    _header(path, gray_only=False)
    return native.read_png_rgb_native(path)


def _quantise(img) -> np.ndarray:
    """[0, 1] floats → uint8 as the JAX package's native codec rounds them
    (NaN and values below 0 to 0, above 1 to 255)."""
    v = np.asarray(img, dtype=np.float64)
    v = np.minimum(np.where(v >= 0.0, v, 0.0), 1.0)
    return (v * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _encode(path: str, samples: np.ndarray, color: int) -> None:
    """Write (rows, cols · channels) uint8 ``samples`` as a PNG of color
    type ``color``, every scanline unfiltered."""
    height, row_bytes = samples.shape
    width = row_bytes // _CHANNELS[color]
    raw = np.zeros((height, row_bytes + 1), np.uint8)   # filter byte 0
    raw[:, 1:] = samples
    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", header)
                 + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                 + _chunk(b"IEND", b""))


def write_png_gray(path: str, img) -> None:
    """Write a [0, 1] (rows, cols) float array as an 8-bit grayscale
    PNG."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError(f"expected a 2-D grayscale image, got {img.shape}")
    if native.library() is not None:
        native.write_png_gray_native(path, img)
    else:
        _encode(path, _quantise(img), 0)


def write_png_color(path: str, img) -> None:
    """Write a planar (3, rows, cols) [0, 1] array as an 8-bit RGB PNG."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[0] != 3:
        raise ValueError(f"expected planar (3, rows, cols), got {img.shape}")
    if native.library() is not None:
        native.write_png_rgb_native(path, img)
        return
    hwc = np.moveaxis(_quantise(img), 0, -1)
    _encode(path, hwc.reshape(hwc.shape[0], -1), 2)
