"""The port's results and reporting against the JAX package on the CPU in
float64: PNG writing, SSIM, ``write_log``, ``save_results`` on identical
arrays, and the files every entry point writes with the default
``save_results=True`` in every family and method.

Inputs: arrays made with numpy from a seed; the bundled one-image datasets
(``circle``, ``circle_sp``, ``color_disks`` cut to one image) at small
budgets for the entry points.  Each test runs in its own ``tmp_path``.

Tolerances: PNG pixels identical (both quantise ``uint8(clip(v)·255 +
0.5)``); SSIM and the quality tables of identical arrays to 1e-12 (the
same float64 arithmetic, filters summed in another order); the entry
points' log rows to 1e-8 relative and the adjoint-CG counts to ± (2 +
10%), the tolerances of tests/test_torch_tr_learn.py; their quality tables
to 1e-6 relative and their PNGs to one grey level (the reconstructions
agree to ~1e-10, which can move a value across a rounding boundary).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel.harness import BilevelState as JState
from bpldenoising_tpu.data import png_io as jpng
from bpldenoising_tpu.experiments import api as japi
from bpldenoising_tpu.experiments import tgv as jtgv
from bpldenoising_tpu.experiments import tvl1 as jtvl1
from bpldenoising_tpu.experiments import vtv as jvtv
from bpldenoising_tpu.metrics import quality as jq
from bpldenoising_tpu.utils.config import Params as JParams
from bpldenoising_tpu.viz import log as jlog
from bpldenoising_tpu_torch.bilevel import harness
from bpldenoising_tpu_torch.data import png_io as tpng
from bpldenoising_tpu_torch.experiments import api as tapi
from bpldenoising_tpu_torch.experiments import tgv as ttgv
from bpldenoising_tpu_torch.experiments import tvl1 as ttvl1
from bpldenoising_tpu_torch.experiments import vtv as tvtv
from bpldenoising_tpu_torch.metrics import quality as tq
from bpldenoising_tpu_torch.utils.config import Params
from bpldenoising_tpu_torch.viz import log as tlog
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                              results_in_tmp)

RTOL = 1e-8


def _pixels(path, color=False):
    """The PNG's 8-bit samples, decoded by the JAX package's reader."""
    img = jpng.read_png_color(path) if color else jpng.read_png_gray(path)
    return np.rint(np.asarray(img) * 255.0).astype(np.int64)


def _images(shape, seed=0):
    """Values over [-0.3, 1.3]: both sides of the clip, and exact grey
    levels ± half a level (the rounding boundary)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-0.3, 1.3, size=shape)
    flat = v.reshape(-1)
    flat[:8] = (np.arange(8) + 0.5) / 255.0
    flat[8:16] = np.arange(8) / 255.0
    return v


@pytest.mark.parametrize("color", [False, True], ids=["gray", "color"])
def test_png_writers_give_the_jax_pixels(tmp_path, color):
    img = _images((3, 20, 17) if color else (20, 17), seed=int(color))
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    (tpng.write_png_color if color else tpng.write_png_gray)(ours, img)
    (jpng.write_png_color if color else jpng.write_png_gray)(theirs, img)
    got, want = _pixels(ours, color), _pixels(theirs, color)
    assert got.shape == want.shape == img.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
    # and the port reads what it wrote
    read = (tpng.read_png_color if color else tpng.read_png_gray)(ours)
    np.testing.assert_array_equal(np.rint(read * 255.0), got)


def test_png_writers_refuse_wrong_shapes(tmp_path):
    with pytest.raises(ValueError):
        tpng.write_png_gray(str(tmp_path / "a.png"), np.zeros((2, 4, 4)))
    with pytest.raises(ValueError):
        tpng.write_png_color(str(tmp_path / "b.png"), np.zeros((4, 4, 3)))


def _ssim_pair(seed, shape=(2, 40, 36)):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(size=shape)
    ref[..., :12, :12] = 0.5               # a flat patch: the clamps bite
    return ref, np.clip(ref + 0.1 * rng.standard_normal(shape), 0, 1)


def test_ssim_matches_jax():
    """ssim (batched), ssim_np and _ssim_any (gray and planar color) to
    1e-12 against the JAX package."""
    ref, img = _ssim_pair(0)
    got = tq.ssim(torch.as_tensor(ref), torch.as_tensor(img)).numpy()
    want = np.asarray(jq.ssim(jnp.asarray(ref), jnp.asarray(img)))
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for i in range(2):
        np.testing.assert_allclose(tq.ssim_np(ref[i], img[i]),
                                   jq.ssim_np(ref[i], img[i]), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(tq.ssim_np(ref[i], img[i]), got[i],
                                   rtol=0, atol=1e-12)
    cref, cimg = _ssim_pair(1, (3, 24, 30))
    np.testing.assert_allclose(tapi._ssim_any(cref, cimg),
                               japi._ssim_any(cref, cimg), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tapi._ssim_any(ref[0], img[0]),
                               japi._ssim_any(ref[0], img[0]), rtol=0,
                               atol=1e-12)
    assert tq.ssim_np(ref[0], ref[0]) == pytest.approx(1.0, abs=1e-12)


def test_ssim_stays_in_range_in_float32():
    """Near-flat windows in float32: the clamps keep the index in [−1, 1]
    (the JAX package's guard against E[x²] − μ² cancelling)."""
    ref = np.full((32, 32), 0.7, np.float32)
    img = ref + np.float32(1e-4) * np.float32(
        np.random.default_rng(2).standard_normal((32, 32)))
    got = float(tq.ssim(torch.as_tensor(ref), torch.as_tensor(img)))
    assert -1.0 <= got <= 1.0


def _log(module, with_cg):
    entries = []
    for i in range(3):
        e = module.BilevelLogEntry(i + 1, 0.25 * i, 10.0 / (i + 1),
                                   2.0 ** -i, 0.1 * 1.9 ** i, 1e-3 * i)
        if with_cg and i != 1:
            e.adjoint_cg_iters, e.adjoint_cg_converged = 40.0 + i, 1.0
        entries.append(e)
    log = module.IterLog()
    log.extend(entries)
    return log


@pytest.mark.parametrize("with_cg", [False, True], ids=["plain", "cg"])
def test_write_log_matches_jax(tmp_path, with_cg):
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    tlog.write_log(str(ours), _log(tlog, with_cg), header="# a header")
    jlog.write_log(str(theirs), _log(jlog, with_cg), header="# a header")
    assert ours.read_text() == theirs.read_text()
    lines = ours.read_text().splitlines()
    assert lines[0] == "# a header" and len(lines) == 5
    assert ("adjoint_cg_iters" in lines[1]) == with_cg


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _table(path):
    """The quality table's numbers (rows of floats)."""
    rows = [line.split() for line in open(path).read().splitlines()[1:]]
    return [np.array([float(v) for v in r]) for r in rows]


def _same_results(tdir, jdir, table_rtol=1e-12, pixel_tol=0):
    """Two output trees: the same files, the same quality numbers, PNGs
    that decode to the same pixels (within ``pixel_tol`` grey levels)."""
    names = _listing(jdir)
    assert _listing(tdir) == names
    for name in names:
        t, j = os.path.join(tdir, name), os.path.join(jdir, name)
        if name.endswith("_quality.txt"):
            for a, b in zip(_table(t), _table(j)):
                np.testing.assert_allclose(a, b, rtol=table_rtol, atol=0)
        elif name.endswith(".png"):
            color = "vtv" in name or "color" in name
            d = np.abs(_pixels(t, color) - _pixels(j, color))
            assert d.max() <= pixel_tol, name
            assert np.mean(d > 0) <= 1e-3, name
    return names


def _state(module_log, state_cls, n=2):
    st = state_cls()
    st.log.extend(_log(module_log, True)[:n])
    return st


@pytest.mark.parametrize("shape", [(), (2, 2), (2, 2, 3)],
                         ids=["scalar", "patch", "patch3"])
def test_save_results_on_identical_arrays(tmp_path, monkeypatch, shape):
    """The JAX package's save_results and the port's on the same host
    arrays: the same file set (log, quality table, PNG triplets, the
    parameter maps of (m, n) and (m, n, 3) weights), the same quality
    numbers to 1e-12, the same decoded pixels, the same log rows."""
    rng = np.random.default_rng(3)
    b = rng.uniform(size=(2, 16, 12))
    b_data = b + 0.1 * rng.standard_normal(b.shape)
    opt = np.clip(b + 0.02 * rng.standard_normal(b.shape), -0.1, 1.1)
    x = rng.uniform(0.01, 0.1, size=shape)
    common = dict(save_results=True, dataset_name="circle_128_10",
                  save_prefix="demo")
    for where, save, params, state in (
            ("port", tapi.save_results, Params(common),
             _state(tlog, harness.BilevelState)),
            ("jax", japi.save_results, JParams(common),
             _state(jlog, JState))):
        os.makedirs(tmp_path / where)
        monkeypatch.chdir(tmp_path / where)
        save(params, b, b_data, x, opt, state)
    names = _same_results(str(tmp_path / "port"), str(tmp_path / "jax"))
    maps = {(): 0, (2, 2): 1, (2, 2, 3): 3}[shape]
    assert len(names) == 2 + 3 * 2 + maps
    log = [open(tmp_path / w / "output" / "circle_128_10" / "demo.txt")
           .read().splitlines()[1:] for w in ("port", "jax")]
    assert log[0] == log[1]
    monkeypatch.chdir(tmp_path)
    tapi.save_results(Params(common, save_results=False), b, b_data, x, opt,
                      harness.BilevelState())
    assert not os.path.exists(tmp_path / "output")


def test_linear_stretch_is_per_stack():
    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 3, size=(3, 5, 4))
    np.testing.assert_array_equal(tapi.linear_stretch(x),
                                  japi.linear_stretch(x))
    np.testing.assert_array_equal(
        tapi.linear_stretch(torch.as_tensor(x, dtype=torch.float32)),
        japi.linear_stretch(x.astype(np.float32)))
    assert np.all(tapi.linear_stretch(np.ones((2, 3))) == 0.0)


# ---------------------------------------------------------------------------
# the entry points with the default save_results=True
# ---------------------------------------------------------------------------

TR = dict(num_samples=1, maxiter=1, inner_maxiter=20)
SL = dict(num_samples=1, sl_outer=2, sl_inner=3, sl_adj=2)
# entry point: (JAX module, port module, dataset, extra keywords)
ENTRIES = {
    "scalar_bilevel_tv_learn": (japi, tapi, "circle", {}),
    "patch_bilevel_tv_learn": (japi, tapi, "circle", {}),
    "scalar_bilevel_sumregs_learn": (japi, tapi, "circle", {}),
    "patch_bilevel_sumregs_learn": (japi, tapi, "circle", {}),
    "scalar_bilevel_tgv_learn": (jtgv, ttgv, "circle",
                                 dict(tgv_gamma=1e-2)),
    "patch_bilevel_tgv_learn": (jtgv, ttgv, "circle", dict(tgv_gamma=1e-2)),
    # TV-L1 at the inner budget of tests/test_torch_fused_tvl1.py: at 20
    # iterations its Huber adjoint stops at the CG cap far from converged,
    # where ‖g‖ moves by 1e-3 under a reordered sum
    "scalar_bilevel_tvl1_learn": (jtvl1, ttvl1, "circle_sp",
                                  dict(inner_maxiter=400)),
    "patch_bilevel_tvl1_learn": (jtvl1, ttvl1, "circle_sp",
                                 dict(inner_maxiter=400)),
    "scalar_bilevel_vtv_learn": (jvtv, tvtv, "color_disks",
                                 dict(vtv_gamma=1e-2)),
    "patch_bilevel_vtv_learn": (jvtv, tvtv, "color_disks",
                                dict(vtv_gamma=1e-2)),
}


def _log_rows(path):
    """A written log's rows without the time column, and its CG counts
    (NaN where the log has no CG columns)."""
    lines = open(path).read().splitlines()
    assert lines[0].startswith("# params = ")
    at = next(i for i, line in enumerate(lines) if line.startswith("# iter"))
    rows = np.array([[float(v) for v in line.split("\t")]
                     for line in lines[at + 1:]])
    cg = rows[:, 6] if rows.shape[1] > 6 else np.full(len(rows), np.nan)
    return rows[:, [0, 2, 3, 4, 5]], cg, lines[at]


def _run_both(tmp_path, monkeypatch, run_port, run_jax):
    for where, run in (("port", run_port), ("jax", run_jax)):
        os.makedirs(tmp_path / where)
        monkeypatch.chdir(tmp_path / where)
        run()
    monkeypatch.chdir(tmp_path)
    names = _same_results(str(tmp_path / "port"), str(tmp_path / "jax"),
                          table_rtol=1e-6, pixel_tol=1)
    for name in names:
        if name.endswith(".txt") and not name.endswith("_quality.txt"):
            rows, cg, cols = _log_rows(tmp_path / "port" / name)
            jrows, jcg, jcols = _log_rows(tmp_path / "jax" / name)
            assert cols == jcols
            np.testing.assert_allclose(rows, jrows, rtol=RTOL, atol=1e-12,
                                       equal_nan=True)
            ok = np.isnan(jcg) | (np.abs(cg - jcg) <= 2 + 0.1 * jcg)
            assert np.all(ok) and np.all(np.isnan(cg) == np.isnan(jcg))
    return names


@pytest.mark.parametrize("method", ["tr", "tr_fused", "single_loop"])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_points_write_the_jax_results(tmp_path, monkeypatch, entry,
                                            method):
    """Every entry point and method, save_results left at its default:
    the port writes the JAX run's files (the JAX prefixes, the stretching
    of each family) with the same log rows, quality numbers and
    pixels."""
    jmod, tmod, ds, extra = ENTRIES[entry]
    kw = dict(TR if method != "single_loop" else SL, dataset_name=ds,
              method=method)
    kw.update(extra)
    jkw = dict(backend="jnp") if jmod is not jtvl1 else {}
    names = _run_both(tmp_path, monkeypatch,
                      lambda: getattr(tmod, entry)(device="cpu", **kw),
                      lambda: getattr(jmod, entry)(**jkw, **kw))
    assert any(n.endswith("_reco_1.png") for n in names)
    assert sum(n.endswith("_quality.txt") for n in names) == 1


def test_image_pair_form_writes_the_jax_results(tmp_path, monkeypatch):
    true_, noisy = tapi.testdataset("circle_128_10")
    pair = (true_[0], noisy[0])
    kw = dict(maxiter=1, inner_maxiter=20)
    names = _run_both(
        tmp_path, monkeypatch,
        lambda: tapi.patch_bilevel_sumregs_learn(image_pair=pair,
                                                 device="cpu", **kw),
        lambda: japi.patch_bilevel_sumregs_learn(image_pair=pair,
                                                 backend="jnp", **kw))
    assert sum(n.endswith("_par_3.png") for n in names) == 1


def test_save_iterations_with_tr_writes_the_jax_snapshots(tmp_path,
                                                          monkeypatch):
    """save_iterations with method="tr": a clipped PNG of each logged
    iterate's first image, <prefix>_iter_<i>.png, as in the JAX
    package."""
    kw = dict(dataset_name="circle", num_samples=1, maxiter=2,
              inner_maxiter=20, save_iterations=True)
    names = _run_both(
        tmp_path, monkeypatch,
        lambda: tapi.scalar_bilevel_tv_learn(device="cpu", **kw),
        lambda: japi.scalar_bilevel_tv_learn(backend="jnp", **kw))
    assert sum("_iter_" in n for n in names) == 2


class _Recorder(harness.LiveView):
    """A live view whose frames are kept (the renderer of the tests)."""
    made = []

    def __init__(self):
        self.frames = []
        super().__init__(renderer=lambda im, p: self.frames.append((im, p)))
        _Recorder.made.append(self)


def test_visualise_with_tr_shows_each_logged_iterate(monkeypatch):
    """visualise=True with method="tr": each logged iterate's first image
    (and, for a patch grid, the normalised parameter map) goes to the live
    view, which is closed at the end; the run is the one without it."""
    _Recorder.made = []
    monkeypatch.setattr(harness, "LiveView", _Recorder)
    kw = dict(dataset_name="circle", num_samples=1, maxiter=2,
              inner_maxiter=20, save_results=False)
    res = tapi.patch_bilevel_tv_learn(device="cpu", visualise=True, **kw)
    plain = tapi.patch_bilevel_tv_learn(device="cpu", **kw)
    np.testing.assert_array_equal(res.x, plain.x)
    view, = _Recorder.made
    assert view._thread is None                    # closed
    assert 1 <= view.frames_drawn == len(view.frames) <= 2
    image, pmap = view.frames[-1]
    assert image.shape == (128, 128) and pmap.shape == (2, 2)
    assert pmap.min() >= 0.0 and pmap.max() <= 1.0
    assert res.state.view is view


def test_tv_denoise_and_l2_cost_match_jax():
    """TVDenoise with a scalar α and an (m, n) grid (kernel A's plain
    version on the CPU) and L2CostFunction against the JAX package."""
    true_, noisy = tapi.testdataset("circle_128_10")
    for p in (0.08, np.array([[0.05, 0.1], [0.12, 0.07]])):
        got = tapi.TVDenoise(noisy, p, maxiter=40, device="cpu")
        want = japi.TVDenoise(jnp.asarray(noisy), p, maxiter=40)
        assert got.shape == (1, 128, 128) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(tapi.L2CostFunction(got, true_),
                                   japi.L2CostFunction(want, true_),
                                   rtol=1e-12)


def test_tv_denoise_visualize_shows_the_result(monkeypatch):
    _Recorder.made = []
    monkeypatch.setattr(tapi, "LiveView", _Recorder)
    _, noisy = tapi.testdataset("circle_128_10")
    u = tapi.TVDenoise(noisy, 0.08, visualize=True, maxiter=5, device="cpu")
    view, = _Recorder.made
    view.close()
    np.testing.assert_array_equal(view.frames[-1][0], u[0].numpy())
