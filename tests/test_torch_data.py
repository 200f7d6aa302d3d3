"""The port's data, metrics and state hand-over (bpldenoising_tpu_torch
data/metrics/weights) against the JAX package.

Datasets must load bit-exactly; PSNR and the L2 cost agree to 1e-12
(the same float64 arithmetic).
"""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu import data as jdata
from bpldenoising_tpu.metrics import quality as jq
from bpldenoising_tpu_torch import data as tdata
from bpldenoising_tpu_torch.data import png_io
from bpldenoising_tpu_torch.metrics import quality as tq
from bpldenoising_tpu_torch.weights import from_jax_state

GRAY_DATASETS = ["faces_train_128_10", "faces_val_128_10", "circle_128_10",
                 "cameraman_128_5", "pyramid_128_10", "circle_sp_128_20"]


@pytest.mark.parametrize("name", GRAY_DATASETS)
def test_dataset_loads_bit_exact(name):
    got = tdata.testdataset(name)
    want = jdata.testdataset(name)
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == w.shape
        assert np.array_equal(g, w)


def test_flagship_dataset_shape():
    true_, noisy = tdata.load_dataset(
        f"{tdata.dataset_dir}/faces_train_128_10")
    assert true_.shape == noisy.shape == (10, 128, 128)
    assert 0.0 <= noisy.min() and noisy.max() <= 1.0


@pytest.mark.parametrize("name", ["faces_tr", "circle", "cameraman",
                                  "faces_trian"])
def test_full_datasetname_matches_jax(name):
    with pytest.warns() if name == "faces_trian" else _nullcontext():
        got = tdata.full_datasetname(name)
        want = jdata.full_datasetname(name)
    assert got == want


def test_unknown_dataset_raises():
    with pytest.raises(ValueError):
        tdata.full_datasetname("zzzz")


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _png(path, rows, depth=8, filters=None):
    """Write a grayscale PNG with the given scanline filter per row."""
    h = len(rows)
    w = rows[0].size // (depth // 8) if depth >= 8 \
        else rows[0].size * 8 // depth
    raw = b""
    prev = np.zeros(rows[0].size, np.int64)
    for r, line in enumerate(rows):
        ft = filters[r % len(filters)] if filters else 0
        line = line.astype(np.int64)
        bpp = max(1, depth // 8)
        out = np.zeros_like(line)
        for c in range(line.size):
            left = line[c - bpp] if c >= bpp else 0
            up = prev[c]
            ul = prev[c - bpp] if c >= bpp else 0
            pred = [0, left, up, (left + up) >> 1,
                    int(png_io._paeth(left, up, ul))][ft]
            out[c] = (line[c] - pred) & 0xFF
        raw += bytes([ft]) + bytes(out.astype(np.uint8))
        prev = line

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(png_io._SIGNATURE + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_filter_types(tmp_path, rng, ftype):
    img = rng.integers(0, 256, (6, 7), dtype=np.uint8)
    path = tmp_path / "f.png"
    _png(path, list(img), filters=[ftype])
    got = png_io.read_png_gray(str(path))
    assert np.array_equal(got, img.astype(np.float64) * (1.0 / 255.0))


def test_png_mixed_filters_and_16_bit(tmp_path, rng):
    img = rng.integers(0, 65536, (5, 4))
    rows = [np.stack([r >> 8, r & 0xFF], axis=-1).reshape(-1) for r in img]
    path = tmp_path / "g.png"
    _png(path, rows, depth=16, filters=[4, 3, 1, 2, 0])
    got = png_io.read_png_gray(str(path))
    assert np.array_equal(got, img.astype(np.float64) * (1.0 / 65535.0))


def test_png_rejects_color(tmp_path):
    path = tmp_path / "c.png"
    ihdr = struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0)
    body = png_io._SIGNATURE + struct.pack(">I", 13) + b"IHDR" + ihdr \
        + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr) & 0xFFFFFFFF)
    path.write_bytes(body)
    with pytest.raises(NotImplementedError):
        png_io.read_png_gray(str(path))


def test_psnr_and_cost_match_jax(rng):
    ref = rng.random((3, 9, 11))
    img = ref + 0.05 * rng.standard_normal(ref.shape)
    np.testing.assert_allclose(
        tq.psnr(torch.from_numpy(ref), torch.from_numpy(img)).numpy(),
        np.asarray(jq.psnr(jnp.asarray(ref), jnp.asarray(img))), rtol=1e-12)
    assert tq.psnr_np(ref, img) == pytest.approx(jq.psnr_np(ref, img),
                                                 rel=1e-12)
    np.testing.assert_allclose(
        float(tq.l2_cost(torch.from_numpy(img), torch.from_numpy(ref))),
        float(jq.l2_cost(jnp.asarray(img), jnp.asarray(ref))), rtol=1e-12)


def test_from_jax_state_round_trip(rng):
    u = jnp.asarray(rng.standard_normal((2, 4, 5)))
    ys = (jnp.asarray(rng.standard_normal((2, 2, 4, 5))),)
    state = from_jax_state(((u, ys), [jnp.asarray(0.5), None]),
                           device="cpu")
    (tu, tys), (ta, tnone) = state
    assert isinstance(tys, tuple) and tnone is None
    assert np.array_equal(tu.numpy(), np.asarray(u))
    assert np.array_equal(tys[0].numpy(), np.asarray(ys[0]))
    assert float(ta) == 0.5
    tf = from_jax_state(u, device="cpu", dtype=torch.float32)
    assert tf.dtype == torch.float32
