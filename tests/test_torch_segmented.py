"""Segmented dispatch, checkpoint and resume, and the profiling utilities
of the port (``bilevel/tr_core.py::run_segmented``, ``bilevel/fused.py::
drive``, ``experiments/api.py``, ``utils/checkpoint.py``,
``utils/profiling.py``, the CLI's ``--checkpoint``, ``--resume``,
``--log-every`` and ``--trace``) on the CPU in float64, against the JAX
package where it has the same function (after its tests/test_fused.py,
test_fused_tgv.py, test_tvl1_methods.py, test_experiments.py and
test_utils.py).

Inputs: small discs, ramps and salt-and-pepper stacks made with numpy
from seeds for the library learners; the bundled ``circle`` dataset
(one 128² image) for the entry points, at small budgets.

Tolerances: segmented against single runs bit for bit (the same body on
the same carry); the resumed learn against the uninterrupted one at the
JAX test's rtol = 5e-2 on x, and against the JAX package's own resumed
learn at 1e-8 relative (the entry points' agreement elsewhere,
tests/test_torch_fused.py).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel.fused_tgv import \
    bilevel_learn_tgv_fused as j_learn_tgv_fused
from bpldenoising_tpu.experiments import tvl1 as jtvl1
from bpldenoising_tpu.utils import checkpoint as jck
from bpldenoising_tpu.utils.config import Params as JParams
from bpldenoising_tpu_torch import experiments as tx
from bpldenoising_tpu_torch.__main__ import main
from bpldenoising_tpu_torch.bilevel.fused import bilevel_learn_fused
from bpldenoising_tpu_torch.bilevel.fused_tgv import bilevel_learn_tgv_fused
from bpldenoising_tpu_torch.bilevel.fused_tvl1 import \
    bilevel_learn_tvl1_fused
from bpldenoising_tpu_torch.bilevel.fused_vtv import bilevel_learn_vtv_fused
from bpldenoising_tpu_torch.bilevel.tr_core import run_segmented
from bpldenoising_tpu_torch.models import sumregs_model
from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
from bpldenoising_tpu_torch.utils import (CheckpointWriter, SectionTimer,
                                          load_checkpoint, save_checkpoint,
                                          trace)
from bpldenoising_tpu_torch.utils.config import Params
from bpldenoising_tpu_torch.viz.log import BilevelLogEntry
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                              results_in_tmp)

TR = dict(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.1,
          maxiter=7, tol=1e-9)
CFG = HypergradConfig(al_iters=2, cg_maxiter=300)


def _disc(n, shift=0):
    x, y = np.meshgrid(np.arange(n), np.arange(n))
    return ((x - n / 2 - shift) ** 2 + (y - n / 2) ** 2
            < (n / 3) ** 2).astype(float)


def _data(name):
    rng = np.random.default_rng(0)
    if name == "tgv":
        x, y = np.meshgrid(np.linspace(0, 1, 12), np.linspace(0, 1, 12))
        clean = np.stack([0.5 * x + 0.3 * (y > 0.5), 0.4 * y])
        return clean, clean + 0.05 * rng.standard_normal(clean.shape)
    if name == "tvl1":
        clean = _disc(16)[None]
        noisy = clean.copy()
        hit = rng.random(clean.shape) < 0.2
        noisy[hit] = rng.random(int(hit.sum()))
        return clean, noisy
    if name == "vtv":
        d = _disc(12)
        clean = np.stack([d, 0.5 * d, d[::-1]])[None]
        return clean, clean + 0.1 * rng.standard_normal(clean.shape)
    clean = np.stack([_disc(16), _disc(16, 2)])
    return clean, clean + 0.1 * rng.standard_normal(clean.shape)


# name: (learner, x0, keywords)
LEARNS = {
    "tv": (bilevel_learn_fused, 0.1,
           dict(inner_maxiter=300, inner_tol=1e-7, check_every=50, cfg=CFG)),
    "sumregs_lbfgs": (bilevel_learn_fused, 1e-3 * np.ones((2, 2, 3)),
                      dict(model=sumregs_model(), inner_maxiter=200,
                           inner_tol=None, delta_t=1e-3, cfg=CFG)),
    "tgv": (bilevel_learn_tgv_fused, np.array([0.05, 0.05]),
            dict(inner_maxiter=300, inner_tol=None, gamma=1e-2)),
    "tvl1": (bilevel_learn_tvl1_fused, 0.4,
             dict(inner_maxiter=300, inner_tol=1e-6, check_every=100)),
    "vtv": (bilevel_learn_vtv_fused, 0.05,
            dict(inner_maxiter=200, inner_tol=None, gamma=1e-2)),
}


def _learn(name, **kw):
    learn, x0, fixed = LEARNS[name]
    tr = dict(TR, lbfgs_threshold=8) if name == "sumregs_lbfgs" else TR
    return learn(_data(name), xinit=x0, params=Params(tr), device="cpu",
                 **fixed, **kw)


@pytest.mark.parametrize("name", list(LEARNS))
def test_segmented_matches_single_run_bit_for_bit(name):
    """log_every segments run the loop's body on the same carry: x, the
    log matrix, u and the iteration count are the single run's bits; the
    hops are at most log_every apart and end at the iterations; the times
    are one per iteration, positive and non-decreasing (None in a single
    run)."""
    one = _learn(name)
    hops = []
    seg = _learn(name, log_every=3,
                 segment_callback=lambda it, carry, t: hops.append((it, t)))
    assert seg.iterations == one.iterations > 0
    assert torch.equal(seg.x, one.x) and torch.equal(seg.log, one.log)
    assert torch.equal(seg.u, one.u) and torch.equal(seg.cost, one.cost)
    assert one.times is None
    its = [0] + [it for it, _ in hops]
    assert its[-1] == seg.iterations
    assert all(0 < b - a <= 3 for a, b in zip(its, its[1:]))
    assert seg.times.shape == (seg.iterations,)
    assert np.all(seg.times > 0) and np.all(np.diff(seg.times) >= 0)
    assert [t for _, t in hops] == sorted(set(seg.times.tolist()))


def test_run_segmented_stops_as_the_loop_does():
    """A radius below tol or a segment that runs nothing ends the drive;
    times[i] is the end of the segment that holds iteration i."""
    calls = []

    def segment(c):
        it = min(c[0] + 2, 5)
        calls.append(it)
        return (it, None, None, torch.tensor(0.1 if it < 5 else 1e-9))

    carry, times = run_segmented(
        lambda: (0, None, None, torch.tensor(0.1)), segment, maxiter=8,
        tol=1e-6)
    assert carry[0] == 5 and calls == [2, 4, 5]
    assert times[0] == times[1] < times[2] == times[3] < times[4]
    assert np.all(times[5:] == 0)


def test_init_B_is_spliced_as_in_the_jax_package():
    """A dense BFGS matrix restored into the first carry: the trajectory
    is the JAX package's segmented run with the same init_B (1e-8), and
    differs from a run from 0.1·I; the L-BFGS model ignores it, and a
    single run ignores a lone segment_callback."""
    clean, noisy = _data("tgv")
    B0 = np.array([[30.0, 5.0], [5.0, 70.0]])
    kw = dict(xinit=np.array([0.05, 0.05]), inner_maxiter=300,
              inner_tol=None, gamma=1e-2)
    res = bilevel_learn_tgv_fused((clean, noisy), params=Params(TR),
                                  device="cpu", log_every=2, init_B=B0,
                                  **kw)
    jres = j_learn_tgv_fused((jnp.asarray(clean), jnp.asarray(noisy)),
                             params=JParams(TR), backend="jnp", log_every=2,
                             init_B=jnp.asarray(B0), **kw)
    k = int(jres.iterations)
    assert res.iterations == k
    np.testing.assert_allclose(res.log[:k, :4].numpy(),
                               np.asarray(jres.log)[:k, :4], rtol=1e-8,
                               atol=1e-14)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-8)
    plain = bilevel_learn_tgv_fused((clean, noisy), params=Params(TR),
                                    device="cpu", **kw)
    assert not torch.equal(plain.log[0], res.log[0])
    lb = _learn("sumregs_lbfgs")
    assert torch.equal(_learn("sumregs_lbfgs", init_B=np.eye(12)).x, lb.x)
    # a lone segment_callback (no log_every) is ignored, as in JAX
    assert torch.equal(_learn("tv", segment_callback=lambda *a: None).x,
                       _learn("tv").x)


FAST = dict(dataset_name="circle_sp", num_samples=1, inner_maxiter=200,
            maxiter=4)
CKPT = os.path.join("output", "circle_sp_128_20",
                    "tvl1_optimal_parameter_scalar_circle_sp_128_20_ckpt.npz")


@pytest.mark.parametrize("method", ["tr_fused", "tr"])
def test_checkpoint_then_resume_continues(method):
    """Interrupt after 2 iterations (maxiter=2 with checkpoint), resume
    with the whole budget: the checkpoint holds x, Δ, B and the log, the
    resumed log numbers its iterations strictly increasing, x lands within
    5e-2 of the uninterrupted run's (the JAX test's band) and at the JAX
    package's resumed x (1e-8).  On the TV-L1 entry point, whose learn is
    the cheapest on the CPU; every family runs the same code
    (experiments/api.py)."""
    seg = dict(log_every=2) if method == "tr_fused" else {}
    kw = dict(FAST, method=method, **seg)
    full = tx.scalar_bilevel_tvl1_learn(device="cpu", **kw)
    tx.scalar_bilevel_tvl1_learn(device="cpu", checkpoint=True,
                                 **dict(kw, maxiter=2))
    state = load_checkpoint(CKPT)
    assert int(state["iteration"]) == 2 and state["log"].shape == (2, 6)
    assert state["B"].shape == (1, 1) and state["x"].shape == ()
    res = tx.scalar_bilevel_tvl1_learn(device="cpu", resume=True, **kw)
    iters = [e.iter for e in res.state.log]
    assert res.iterations >= 3 and iters == list(range(1, len(iters) + 1))
    np.testing.assert_allclose(float(res.x), float(full.x), rtol=5e-2)
    jkw = dict(kw, save_results=False)
    os.remove(CKPT)
    jtvl1.scalar_bilevel_tvl1_learn(checkpoint=True, **dict(jkw, maxiter=2))
    jres = jtvl1.scalar_bilevel_tvl1_learn(resume=True, **jkw)
    assert [e.iter for e in jres.state.log] == iters
    np.testing.assert_allclose(float(res.x), float(jres.x), rtol=1e-8)
    np.testing.assert_allclose(res.cost, jres.cost, rtol=1e-8)


@pytest.mark.parametrize("learn", ["scalar_bilevel_tgv_learn",
                                   "patch_bilevel_tvl1_learn",
                                   "scalar_bilevel_vtv_learn"])
def test_family_checkpoint_snapshots_and_times(learn):
    """Every family's fused learn with checkpoint and save_iterations:
    the checkpoint, one snapshot PNG a segment, and the log's times real
    and non-decreasing (one per iteration)."""
    kw = dict(tgv=dict(dataset_name="circle", tgv_gamma=1e-2),
              tvl1=dict(dataset_name="circle_sp"),
              vtv=dict(dataset_name="color_disks", vtv_gamma=1e-2))[
                  learn.split("_")[2]]
    res = getattr(tx, learn)(device="cpu", method="tr_fused", num_samples=1,
                             maxiter=3, inner_maxiter=60, checkpoint=True,
                             save_iterations=True, log_every=2, **kw)
    files = [f for _, _, fs in os.walk("output") for f in fs]
    assert sum(f.endswith("_ckpt.npz") for f in files) == 1
    snaps = sorted(f for f in files if "_iter_" in f)
    assert snaps and all(f.endswith(".png") for f in snaps)
    times = [e.time for e in res.state.log]
    assert len(times) == res.iterations and all(t > 0 for t in times)
    assert times == sorted(times)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint the port writes reads back in the JAX package, and one
    the JAX package writes in the port: the same keys and values."""
    rows = np.arange(12.0).reshape(2, 6)
    B = np.array([[2.0, 0.5], [0.5, 3.0]])
    ours, theirs = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    save_checkpoint(ours, x=np.array([0.1, 0.2]), delta=0.05, B=B,
                    log_rows=rows, iteration=7)
    jck.save_checkpoint(theirs, x=np.array([0.1, 0.2]), delta=0.05, B=B,
                        log_rows=rows, iteration=7)
    for got in (jck.load_checkpoint(ours), load_checkpoint(theirs)):
        assert sorted(got) == ["B", "delta", "iteration", "log", "x"]
        np.testing.assert_array_equal(got["x"], [0.1, 0.2])
        np.testing.assert_array_equal(got["B"], B)
        np.testing.assert_array_equal(got["log"], rows)
        assert float(got["delta"]) == 0.05 and int(got["iteration"]) == 7
    save_checkpoint(ours, x=0.3, delta=0.1)
    assert jck.load_checkpoint(ours)["B"] is None
    assert load_checkpoint(str(tmp_path / "none.npz")) is None
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp.npz")]
    writer = CheckpointWriter(str(tmp_path / "sub" / "c.npz"))
    writer(1, np.array(0.2), 0.01,
           [BilevelLogEntry(1, 0.5, 2.0, 0.1, 0.01, 0.02)], B=np.eye(1))
    got = jck.load_checkpoint(str(tmp_path / "sub" / "c.npz"))
    np.testing.assert_array_equal(got["log"], [[1, 0.5, 2.0, 0.1, 0.01,
                                                0.02]])


def test_section_timer_and_trace(tmp_path):
    """SectionTimer accumulates by name; trace(None) is a no-op and
    trace(dir) writes a Chrome trace of the region."""
    t = SectionTimer()
    x = torch.ones(4)
    for _ in range(2):
        with t.section("a", result_holder=(x, [x])):
            x = x * 2
    assert t.totals["a"] > 0 and t.counts["a"] == 2
    assert "a" in t.report() and "(n=2)" in t.report()
    with trace(None):
        pass
    assert not os.listdir(tmp_path)
    with trace(str(tmp_path / "tr")):
        torch.linalg.norm(torch.ones(64, 64) @ torch.ones(64, 64))
    with open(tmp_path / "tr" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("learn", ["patch_bilevel_tv_learn",
                                   "scalar_bilevel_sumregs_learn",
                                   "patch_bilevel_tgv_learn",
                                   "patch_bilevel_tvl1_learn",
                                   "patch_bilevel_vtv_learn"])
def test_single_loop_rejects_what_runs_as_one_computation(learn):
    """The JAX package's _reject_flags: checkpoint, resume,
    save_iterations and inner_tol raise its ValueError with
    method="single_loop", before any work."""
    for flag in ("checkpoint", "resume", "save_iterations", "inner_tol"):
        with pytest.raises(ValueError, match=f"{flag} is not supported "
                           "with method='single_loop'"):
            getattr(tx, learn)(device="cpu", method="single_loop",
                               **{flag: 1e-3})


def test_cli_checkpoint_resume_log_every_and_trace(tmp_path, capsys):
    """The CLI's --checkpoint, then --resume with --log-every, and
    --trace DIR: the resumed run reports the whole budget's iterations,
    the checkpoint moves on, the trace file holds the learn's events."""
    base = ["scalar-tvl1", "--inner-maxiter", "100", "--method", "tr_fused",
            "--device", "cpu"]
    main(base + ["--maxiter", "2", "--checkpoint", "--log-every", "1"])
    assert int(load_checkpoint(CKPT)["iteration"]) == 2
    capsys.readouterr()
    main(base + ["--maxiter", "3", "--resume", "--log-every", "1",
                 "--trace", str(tmp_path / "tr")])
    assert "iterations = 3" in capsys.readouterr().out
    assert int(load_checkpoint(CKPT)["iteration"]) == 3
    with open(tmp_path / "tr" / "trace.json") as fh:
        assert json.load(fh)["traceEvents"]
