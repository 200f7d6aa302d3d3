"""The port's built PNG codec (bpldenoising_tpu_torch/data/native, the C++
source built with g++ and zlib) against its pure-Python codec
(data/png_io.py): every bundled PNG under datasets/ and images/ decodes to
the same bits, written files decode alike, and the refusals.  The codec
is built into a temporary ``_build`` here, never into the package or the
JAX package's tree."""

import glob
import os
import struct
import zlib

import numpy as np
import pytest

from bpldenoising_tpu_torch.data import native, png_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLED = sorted(glob.glob(os.path.join(ROOT, "datasets", "*", "*.png"))
                 + glob.glob(os.path.join(ROOT, "images", "*.png")))


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("codec") / "_build"


@pytest.fixture
def codec(build_dir, monkeypatch):
    """The codec built into the temporary _build (once for the module),
    as png_io's backend."""
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "backend", None)
    lib = native.library()
    assert lib is not None, native.build_error
    assert native.backend == "native"
    return lib


def test_builds_into_the_given_dir_keyed_on_the_source(build_dir, codec):
    built = sorted(build_dir.iterdir())
    assert [p.name for p in built] == [f"png_codec_{native._key()}.so"]
    mtime = built[0].stat().st_mtime_ns
    assert native.build(build_dir) == built[0]          # no second build
    assert built[0].stat().st_mtime_ns == mtime
    assert not glob.glob(os.path.join(
        ROOT, "bpldenoising_tpu", "data", "native", "png_codec_*"))


def test_bundled_pngs_decode_bit_equal(codec):
    """Every bundled PNG (8-bit gray, 8-bit RGB, 1-bit gray) that the
    pure-Python reader takes: the built codec's gray and planar color
    arrays equal it bit for bit."""
    assert len(BUNDLED) >= 60
    for path in BUNDLED:
        with open(path, "rb") as fh:
            color = fh.read(26)[25] == 2
        if not color:
            got = png_io.read_png_gray(path)
            want = png_io.read_png_gray_python(path)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        got = png_io.read_png_color(path)
        want = png_io.read_png_color_python(path)
        assert got.shape == want.shape and np.array_equal(got, want), path


@pytest.mark.parametrize("color", [False, True], ids=["gray", "color"])
def test_written_files_decode_alike(codec, tmp_path, rng, color):
    """The codec's writer and the Python writer quantise alike (NaN and
    values outside [0, 1] included); each reader reads the other's file."""
    img = rng.uniform(-0.2, 1.2, (3, 9, 13) if color else (9, 13))
    img.flat[5] = np.nan
    write, read, read_py = (
        (png_io.write_png_color, png_io.read_png_color,
         png_io.read_png_color_python) if color else
        (png_io.write_png_gray, png_io.read_png_gray,
         png_io.read_png_gray_python))
    built, py = str(tmp_path / "c.png"), str(tmp_path / "p.png")
    write(built, img)
    (png_io._encode(py, png_io._quantise(img), 0) if not color else
     png_io._encode(py, np.moveaxis(png_io._quantise(img), 0, -1).reshape(
         9, -1), 2))
    for a, b in ((read(built), read_py(py)), (read(py), read_py(built))):
        assert np.array_equal(a, b)
    assert np.abs(read(built) - np.clip(np.nan_to_num(img), 0, 1)).max() \
        <= 0.5 / 255 + 1e-12


def test_refusals(codec, tmp_path):
    """A decode error of the built codec raises OSError, not a retry in
    Python; the header rules are the Python reader's (a color file read as
    gray, a palette image, interlacing); a missing file and a bad shape
    raise as before."""
    bad = tmp_path / "bad.png"
    bad.write_bytes(png_io._SIGNATURE + b"garbage that is not a chunk")
    with pytest.raises(ValueError, match="IHDR"):
        png_io.read_png_gray(str(bad))
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 0)
    broken = tmp_path / "broken.png"
    broken.write_bytes(png_io._SIGNATURE + png_io._chunk(b"IHDR", ihdr)
                       + png_io._chunk(b"IDAT", b"not zlib")
                       + png_io._chunk(b"IEND", b""))
    with pytest.raises(OSError, match="native PNG decode failed"):
        png_io.read_png_gray(str(broken))
    with pytest.raises(zlib.error):
        png_io.read_png_gray_python(str(broken))
    for color, interlace in ((2, 0), (3, 0), (0, 1)):
        head = struct.pack(">IIBBBBB", 1, 1, 8, color, 0, 0, interlace)
        path = tmp_path / f"h{color}{interlace}.png"
        path.write_bytes(png_io._SIGNATURE + png_io._chunk(b"IHDR", head)
                         + png_io._chunk(b"IDAT", zlib.compress(b"\0\0"))
                         + png_io._chunk(b"IEND", b""))
        with pytest.raises(NotImplementedError):
            png_io.read_png_gray(str(path))
    with pytest.raises(FileNotFoundError):
        png_io.read_png_gray(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError, match="planar"):
        png_io.write_png_color(str(tmp_path / "x.png"), np.zeros((4, 4)))
    with pytest.raises(OSError, match="encode failed"):
        native.write_png_gray_native(str(tmp_path / "no" / "dir.png"),
                                     np.zeros((2, 2)))


def test_python_codec_where_the_build_fails(tmp_path, monkeypatch):
    """No compiler: library() is None, backend "python" with the reason,
    and the readers and writers run in pure Python."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "backend", None)
    assert native.library() is None and native.backend == "python"
    assert "no-such-g++" in native.build_error
    path = BUNDLED[0]
    assert np.array_equal(png_io.read_png_gray(path),
                          png_io.read_png_gray_python(path))
    with pytest.raises(OSError, match="not built"):
        native.read_png_gray_native(path)
    assert not (tmp_path / "_build").exists() or not list(
        (tmp_path / "_build").glob("*.so"))
