"""ctypes bindings for the port's C++ PNG codec (``png_codec.cpp``;
counterpart of ``bpldenoising_tpu.data.native``).

The codec is built at first use, never at import: ``g++ -O2 -shared -fPIC
… -lz`` into the package's ``_build/`` (gitignored), under a file name
keyed on a hash of the source and the flags, written to a temporary name
and moved into place atomically (so parallel processes may race).
:func:`library` returns the loaded library, or ``None`` when the build
fails (no ``g++`` or no ``zlib.h``); :mod:`..png_io` then reads and writes
in pure Python.  ``backend`` records which codec runs: ``None`` before the
first use, then ``"native"`` or ``"python"``; ``build_error`` holds a failed
build's message.  A decode or encode error of the built codec raises
``OSError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["read_png_gray_native", "write_png_gray_native",
           "read_png_rgb_native", "write_png_rgb_native", "library",
           "build"]

SRC = Path(__file__).resolve().parent / "png_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

backend: str | None = None
build_error: str | None = None
_lib = None          # the loaded library, False once the build failed
_lock = threading.Lock()


def _key() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return h.hexdigest()[:16]


def build(build_dir=None) -> Path:
    """Compile the codec into ``build_dir`` (default ``_build/``) unless
    the library for this source exists; → its path."""
    out = Path(build_dir or BUILD_DIR) / f"png_codec_{_key()}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, str(SRC), "-lz"],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    dbl_p = ctypes.POINTER(ctypes.c_double)
    read_args = [ctypes.c_char_p, ctypes.POINTER(dbl_p),
                 ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    write_args = [ctypes.c_char_p, dbl_p, ctypes.c_int, ctypes.c_int]
    for name, args in (("png_read_gray", read_args),
                       ("png_read_rgb", read_args),
                       ("png_write_gray", write_args),
                       ("png_write_rgb", write_args)):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
    lib.png_free.restype, lib.png_free.argtypes = None, [dbl_p]
    return lib


def library():
    """The built codec, or ``None`` where it cannot be built."""
    global _lib, backend, build_error
    with _lock:
        if _lib is None:
            try:
                _lib, backend = _load(build()), "native"
            except subprocess.CalledProcessError as exc:
                _lib, backend = False, "python"
                build_error = f"{' '.join(exc.cmd)}:\n{exc.stderr}"
            except OSError as exc:          # no g++, or a library not loaded
                _lib, backend, build_error = False, "python", str(exc)
        return _lib or None


def _read(fn_name: str, path: str, planes: tuple) -> np.ndarray:
    lib = library()
    if lib is None:
        raise OSError(f"the PNG codec is not built: {build_error}")
    out = ctypes.POINTER(ctypes.c_double)()
    rows, cols = ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, fn_name)(os.fsencode(path), ctypes.byref(out),
                               ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise OSError(f"native PNG decode failed ({rc}): {path}")
    try:
        return np.ctypeslib.as_array(
            out, shape=planes + (rows.value, cols.value)).copy()
    finally:
        lib.png_free(out)


def _write(fn_name: str, path: str, arr: np.ndarray) -> None:
    lib = library()
    if lib is None:
        raise OSError(f"the PNG codec is not built: {build_error}")
    rc = getattr(lib, fn_name)(
        os.fsencode(path),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr.shape[-2], arr.shape[-1])
    if rc != 0:
        raise OSError(f"native PNG encode failed ({rc}): {path}")


def read_png_gray_native(path: str) -> np.ndarray:
    """Decode a PNG to a (rows, cols) float64 array in [0, 1] (8-bit RGB
    to ITU-R 601 luma)."""
    return _read("png_read_gray", path, ())


def read_png_rgb_native(path: str) -> np.ndarray:
    """Decode a PNG to a planar (3, rows, cols) float64 array in [0, 1]
    (grayscale sources replicate the channel)."""
    return _read("png_read_rgb", path, (3,))


def write_png_gray_native(path: str, img) -> None:
    """Encode a (rows, cols) [0, 1] array as an 8-bit grayscale PNG."""
    arr = np.ascontiguousarray(np.asarray(img, dtype=np.float64))
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D grayscale image, got {arr.shape}")
    _write("png_write_gray", path, arr)


def write_png_rgb_native(path: str, img) -> None:
    """Encode a planar (3, rows, cols) [0, 1] array as an 8-bit RGB PNG."""
    arr = np.ascontiguousarray(np.asarray(img, dtype=np.float64))
    if arr.ndim != 3 or arr.shape[0] != 3:
        raise ValueError(f"expected planar (3, rows, cols), got {arr.shape}")
    _write("png_write_rgb", path, arr)
