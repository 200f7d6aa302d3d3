"""The port's validations (``validate_*_parameter``) and cost sweeps
(``generate_*_cost`` and their plots) in all five families against the
JAX package on the CPU in float64 (the kernels' plain versions).

Budgets: the JAX functions fix 10,000 (TV, TGV², VTV) and 5000 (the sum
of regularizers) iterations; both sides are patched to the same small
budget (the module-level denoiser each validation calls, or the
``maxiter`` / ``inner_maxiter`` keyword where there is one), so each test
takes seconds.  Data: the bundled datasets, whole (a validation ignores
``num_samples``, as in the JAX package).

Tolerance: cost, mean PSNR and mean SSIM within 1e-9 relative; the sweeps'
costs too, with the same ``.npz`` names and keys; the saved files the
same set.
"""

import functools
import os

import numpy as np
import pytest

from bpldenoising_tpu.experiments import api as japi
from bpldenoising_tpu.experiments import tgv as jtgv
from bpldenoising_tpu.experiments import tvl1 as jtvl1
from bpldenoising_tpu.experiments import vtv as jvtv
from bpldenoising_tpu_torch.experiments import api as tapi
from bpldenoising_tpu_torch.experiments import tgv as ttgv
from bpldenoising_tpu_torch.experiments import tvl1 as ttvl1
from bpldenoising_tpu_torch.experiments import vtv as tvtv
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                              results_in_tmp)

RTOL = 1e-9
BUDGET = 30


def _budget(fn, n=BUDGET):
    """``fn`` with its iteration budget forced to ``n``."""
    @functools.wraps(fn)
    def run(*args, **kw):
        kw["maxiter"] = n
        return fn(*args, **kw)
    return run


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _in_dirs(tmp_path, monkeypatch, run_port, run_jax):
    """Run each side in a directory of its own: → (port, JAX) results."""
    out = []
    for where, run in (("port", run_port), ("jax", run_jax)):
        os.makedirs(tmp_path / where)
        monkeypatch.chdir(tmp_path / where)
        out.append(run())
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    return out


# case: (port module and its denoiser to patch, JAX module and its,
# validation name, parameter, keywords)
VALIDATIONS = {
    "tv": (tapi, "TVDenoise", japi, "TVDenoise", "validate_tv_parameter",
           0.07, dict(dataset_name="circle")),
    "tv_patch": (tapi, "TVDenoise", japi, "TVDenoise",
                 "validate_tv_parameter",
                 np.array([[0.05, 0.09], [0.07, 0.11]]),
                 dict(dataset_name="circle")),
    "sumregs": (tapi, "denoise_pdps", japi, "denoise_pdps",
                "validate_sumregs_parameter", np.array([0.03, 0.02, 0.01]),
                dict(dataset_name="circle")),
    "sumregs_patch": (tapi, "denoise_pdps", japi, "denoise_pdps",
                      "validate_sumregs_parameter",
                      np.stack([np.full((2, 2), 0.03),
                                np.array([[0.01, 0.02], [0.03, 0.04]]),
                                np.full((2, 2), 0.005)], axis=-1),
                      dict(dataset_name="circle")),
    "tgv": (ttgv, "TGVDenoise", jtgv, "TGVDenoise",
            "validate_tgv_parameter", np.array([0.085226, 0.044170]),
            dict(dataset_name="circle")),
    "tvl1": (ttvl1, None, jtvl1, None, "validate_tvl1_parameter", 1.9234402,
             dict(dataset_name="circle_sp", inner_maxiter=BUDGET)),
    "vtv": (tvtv, "VTVDenoise", jvtv, "VTVDenoise",
            "validate_vtv_parameter", 0.16529731,
            dict(dataset_name="color_disks")),
}


@pytest.mark.parametrize("case", list(VALIDATIONS))
def test_validation_matches_jax(tmp_path, monkeypatch, case):
    tmod, tfn, jmod, jfn, name, parameter, kw = VALIDATIONS[case]
    if tfn is not None:
        monkeypatch.setattr(tmod, tfn, _budget(getattr(tmod, tfn)))
        monkeypatch.setattr(jmod, jfn, _budget(getattr(jmod, jfn)))
    got, want = _in_dirs(
        tmp_path, monkeypatch,
        lambda: getattr(tmod, name)(parameter, device="cpu", **kw),
        lambda: getattr(jmod, name)(parameter, **kw))
    for key in ("cost", "mean_psnr", "mean_ssim"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    assert isinstance(got["u"], np.ndarray)
    np.testing.assert_allclose(got["u"], np.asarray(want["u"]), rtol=0,
                               atol=1e-10)
    names = _listing(tmp_path / "port")
    prefix = name.replace("validate_", "val_").replace("_parameter", "")
    assert all(os.path.basename(n).startswith(prefix) for n in names)
    assert sum(n.endswith("_quality.txt") for n in names) == 1


def test_validation_uses_the_whole_dataset(tmp_path, monkeypatch):
    """num_samples does not cut a validation (as in the JAX package):
    color_disks validates all its images."""
    monkeypatch.setattr(tvtv, "VTVDenoise", _budget(tvtv.VTVDenoise, 5))
    out = tvtv.validate_vtv_parameter(0.1, device="cpu",
                                      dataset_name="color_disks",
                                      num_samples=1)
    true_, _ = tapi.testdataset("color_disks_128_10", color=True)
    assert out["u"].shape == true_.shape and true_.shape[0] > 1


# sweep: (port function, JAX function, arguments, npz name, keywords)
SWEEPS = {
    "tv": (tapi.generate_scalar_tv_cost, japi.generate_scalar_tv_cost,
           ("circle", np.geomspace(0.01, 0.3, 12)), "_cost",
           dict(maxiter=BUDGET, freq=4)),
    "tv_2d": (tapi.generate_2d_tv_cost, japi.generate_2d_tv_cost,
              ("circle", [0.03, 0.08], [0.02, 0.05, 0.1]), "_cost_2d",
              dict(maxiter=BUDGET)),
    "tgv": (ttgv.generate_tgv_cost, jtgv.generate_tgv_cost,
            ("circle", [0.05, 0.1], [0.03, 0.06]), "_tgv_cost_2d",
            dict(maxiter=BUDGET)),
    "tvl1": (ttvl1.generate_tvl1_cost, jtvl1.generate_tvl1_cost,
             ("circle_sp", [0.5, 1.0, 2.0]), "_tvl1_cost",
             dict(maxiter=BUDGET)),
    "vtv": (tvtv.generate_vtv_cost, jvtv.generate_vtv_cost,
            ("color_disks", [0.05, 0.15, 0.3]), "_vtv_cost",
            dict(maxiter=BUDGET, num_samples=2)),
}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_sweep_matches_jax(tmp_path, monkeypatch, capfd, case):
    """One cold fixed-budget solve per weight against the JAX package's
    vmapped sweep: the costs, the npz file and its keys; the TV sweep's
    stderr lines every ``freq`` weights."""
    tfn, jfn, args, suffix, kw = SWEEPS[case]
    got, want = _in_dirs(tmp_path, monkeypatch,
                         lambda: tfn(*args, device="cpu", **kw),
                         lambda: jfn(*args, **kw))
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)
    ds = tapi.full_datasetname(args[0])
    rel = os.path.join("output", ds, f"{ds}{suffix}.npz")
    assert _listing(tmp_path / "port") == [rel]
    z, zj = (np.load(tmp_path / w / rel) for w in ("port", "jax"))
    assert sorted(z.files) == sorted(zj.files)
    for key in z.files:
        np.testing.assert_allclose(z[key], zj[key], rtol=RTOL, err_msg=key)
    if case == "tv":
        lines = [line for line in capfd.readouterr().err.splitlines()
                 if line.startswith("Denoising parameter")]
        assert len(lines) == 2 * 3         # 12 weights, every 4th, twice


# plot: (port sweep, its plot, arguments, keywords, plot base suffix)
PLOTS = {
    "tv": (tapi.generate_scalar_tv_cost, tapi.generate_cost_plot,
           ("circle", [0.05, 0.1, 0.2]), "_cost_plot"),
    "tv_2d": (tapi.generate_2d_tv_cost, tapi.generate_2d_cost_plot,
              ("circle", [0.05, 0.1], [0.05, 0.1]), "_cost_plot_2d"),
    "tgv": (ttgv.generate_tgv_cost, ttgv.generate_tgv_cost_plot,
            ("circle", [0.05, 0.1], [0.03, 0.06]), "_tgv_cost_plot_2d"),
    "tvl1": (ttvl1.generate_tvl1_cost, ttvl1.generate_tvl1_cost_plot,
             ("circle_sp", [0.5, 1.0, 2.0]), "_tvl1_cost_plot"),
    "vtv": (tvtv.generate_vtv_cost, tvtv.generate_vtv_cost_plot,
            ("color_disks", [0.05, 0.15, 0.3]), "_vtv_cost_plot"),
}


@pytest.mark.parametrize("case", list(PLOTS))
def test_sweep_plots_are_written(case):
    pytest.importorskip("matplotlib")
    sweep, plot, args, suffix = PLOTS[case]
    with pytest.raises(FileNotFoundError):
        plot(args[0])
    sweep(*args, maxiter=5, device="cpu")
    base = plot(args[0])
    ds = tapi.full_datasetname(args[0])
    assert base == os.path.join("output", ds, f"{ds}{suffix}")
    assert os.path.getsize(base + ".png") > 1000
    assert os.path.exists(base + ".pdf")
