"""User-facing experiment API (counterpart of
``bpldenoising_tpu.experiments.api``).

Ported so far: :func:`scalar_bilevel_tv_learn`,
:func:`patch_bilevel_tv_learn`, :func:`scalar_bilevel_sumregs_learn` and
:func:`patch_bilevel_sumregs_learn` (its dataset and ``image_pair=``
forms) with ``method="tr"`` (the default: the host-driven trust region of
:mod:`..bilevel.trust_region` over the learning functions of
:mod:`..learning`, the shape of the JAX package's ``_make_lf`` and
``_run_bilevel``; the ``image_pair=`` form runs only this method, as in
the JAX package), ``method="tr_fused"`` (the shape of ``_run_fused``) and
``method="single_loop"`` (the shape of ``_run_single_loop``: the
first-order learner in ``log_every = outer // 20`` segments, whose log
carries real segment-end times).  Saving PNGs, quality tables and plots,
checkpointing, resuming, per-iteration images and data parallelism are not
ported yet and raise ``NotImplementedError``, as does any ``backend`` but
``"auto"`` (:func:`check_backend`: ``device=`` chooses what runs).

Beyond the JAX surface, ``check_every`` (the inner solve's early-stop
cadence) and ``hypergrad_cfg`` (a :class:`HypergradConfig`) are parameters,
so a caller can run the flagship's settings through this entry point.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bilevel.first_order import single_loop_learn
from ..bilevel.fused import bilevel_learn_fused
from ..bilevel.harness import BilevelResult, BilevelState
from ..bilevel.trust_region import bilevel_learn
from ..data import full_datasetname, testdataset
from ..learning import (make_sumregs_learning_function,
                        make_tv_learning_function)
from ..models import sumregs_model, tv_model
from ..solvers.hypergrad import HypergradConfig
from ..utils.config import Params, check_backend, merge
from ..viz.log import BilevelLogEntry

__all__ = ["scalar_bilevel_tv_learn", "patch_bilevel_tv_learn",
           "scalar_bilevel_sumregs_learn", "patch_bilevel_sumregs_learn",
           "default_params", "bilevel_params", "patch_bilevel_params",
           "sumregs_bilevel_params", "patch_sumregs_bilevel_params",
           "check_backend", "single_loop_log_every", "single_loop_state",
           "run_single_loop", "run_bilevel"]

default_params = Params(
    verbose_iter=1,
    maxiter=20,
    save_results=False,
    dataset_name="cameraman_128_5",
    save_iterations=False,
    tol=1e-5,
    num_samples=1,
    checkpoint=False,
    dtype="float64",
    inner_maxiter=5000,
    inner_tol=None,
    check_every=250,
    hypergrad_cfg=HypergradConfig(),
    data_parallel=False,
    method="tr",
    sl_outer=300, sl_inner=40, sl_adj=10, sl_lr=0.05,   # single-loop knobs
)

bilevel_params = Params(
    eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.1, alpha0=0.1)

# the JAX package's parameter sets of the patch and sum-of-regularizers
# learns (its experiments/api.py:120-132)
patch_bilevel_params = Params(
    eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=1e-4,
    alpha0=1e-4 * np.ones((2, 2)))

sumregs_bilevel_params = Params(
    eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.01,
    alpha0=np.array([1e-3, 1e-3, 1e-3]))

patch_sumregs_bilevel_params = Params(
    eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.5, delta0=0.1,
    alpha0=1e-3 * np.ones((2, 2, 3)))

# each knob that is not ported yet, with its ROADMAP.md §1 item
_UNPORTED_FLAGS = {"save_results": 6, "save_iterations": 6, "checkpoint": 7,
                   "resume": 7, "data_parallel": 10, "log_every": 7}
VISUALISE_REFUSAL = "visualise is not ported yet (ROADMAP.md §1 item 6)"


def reject_unported(params, allow=()) -> None:
    """Raise for every set knob the port does not implement yet (but those
    in ``allow``)."""
    for flag, item in _UNPORTED_FLAGS.items():
        if flag not in allow and params.get(flag):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP.md "
                                      f"§1 item {item})")
    check_backend(params.get("backend", "auto"))


def _load(params, device):
    """Dataset → (O, M, N) tensors on ``device`` in the params dtype;
    ``color=True`` in params loads planar (O, 3, M, N) stacks."""
    true_, data = testdataset(params.dataset_name,
                              color=bool(params.get("color")))
    n = int(params.num_samples)
    dt = getattr(torch, str(params.get("dtype", "float64")))
    return (torch.as_tensor(true_[:n], dtype=dt).to(device),
            torch.as_tensor(data[:n], dtype=dt).to(device))


def _fused_to_result(res) -> BilevelResult:
    """FusedResult (log matrix) → host BilevelResult whose
    ``state.log`` holds one BilevelLogEntry per outer iteration, as the JAX
    package's ``_fused_to_result`` builds it.  Every ``time`` is 0.0:
    segmented dispatch, which times the iterations, is not ported."""
    st = BilevelState()
    k = int(res.iterations)
    for i, row in enumerate(res.log[:k].tolist()):
        st.log.append(BilevelLogEntry(
            i + 1, 0.0, *row[:4], adjoint_cg_iters=row[4],
            adjoint_cg_converged=row[5]))
    return BilevelResult(x=res.x.numpy(), u=res.u.cpu().numpy(),
                         state=st, cost=float(res.cost),
                         g_norm=float(res.g_norm), iterations=k)


def run_bilevel(params, learning_function, device, ds=None
                ) -> BilevelResult:
    """The host trust region behind the experiment surface (the JAX
    package's ``_run_bilevel`` without resume, checkpoints and
    per-iteration images, which raise): ``learning_function`` on ``ds``
    (by default the params' dataset on ``device``), the reconstruction read
    to the host once at the end."""
    reject_unported(params)
    if ds is None:
        ds = _load(params, device)
    res = bilevel_learn(ds, learning_function, xinit=params.alpha0,
                        params=params)
    return dataclasses.replace(res, u=res.u.cpu().numpy())


def _make_lf(params, factory, device):
    """The learning function of ``method="tr"`` (the JAX package's
    ``_make_lf`` without ``data_parallel``, which raises): the inner
    solve's budget, its early stop ``inner_tol`` (which also chains the
    PDPS state across evaluations) at ``check_every``, and
    ``hypergrad_cfg``."""
    solver_kwargs = dict(check_every=int(params.check_every))
    if params.get("inner_tol") is not None:
        solver_kwargs["tol"] = float(params.inner_tol)
    return factory(maxiter=int(params.inner_maxiter),
                   cfg=params.hypergrad_cfg, solver_kwargs=solver_kwargs,
                   device=device)


def _run_fused(params, model_kind, device):
    """The fused trust region on ``tv_model()`` or ``sumregs_model()``, with
    the family's switch radius to the regularized gradient (TV Δt = 1e-6,
    sum of regularizers 1e-3, as in the JAX package)."""
    reject_unported(params)
    ds = _load(params, device)
    model = tv_model() if model_kind == "tv" else sumregs_model()
    delta_t = 1e-6 if model_kind == "tv" else 1e-3
    res = bilevel_learn_fused(
        ds, xinit=params.alpha0, params=params, model=model,
        inner_maxiter=int(params.inner_maxiter),
        inner_tol=params.get("inner_tol"),
        check_every=int(params.check_every), delta_t=delta_t,
        cfg=params.hypergrad_cfg, device=device)
    return _fused_to_result(res)


def _reject_flags(params, method, flags):
    """The JAX package's refusal of what a one-computation method cannot
    honour (its experiments/api.py:395-400)."""
    for flag in flags:
        if params.get(flag):
            raise ValueError(
                f"{flag} is not supported with method='{method}' "
                "(the loop runs as one on-device computation)")


def single_loop_log_every(outer: int) -> int:
    """Segment length of single-loop experiment runs (~20 log entries)."""
    return max(1, int(outer) // 20)


def single_loop_state(res, alpha0):
    """SingleLoopResult → (BilevelState, final ‖g‖), as the JAX package
    builds it: an entry every ``single_loop_log_every`` steps (and at the
    last) with the segment-end cumulative wall time, the cost and
    hypergradient-norm trajectories and the last parameter step; the
    trust-region radius has no first-order counterpart and is NaN."""
    st = BilevelState()
    costs = res.cost_trajectory.cpu().numpy()
    gnorms = res.gnorm_trajectory.cpu().numpy()
    alphas = res.alpha_trajectory.cpu().numpy()
    x0 = np.asarray(alpha0, dtype=float)
    log_every = single_loop_log_every(len(costs))
    for i, c in enumerate(costs):
        if (i + 1) % log_every == 0 or i + 1 == len(costs):
            prev = alphas[i - 1] if i > 0 else x0
            step_norm = float(np.linalg.norm(np.ravel(alphas[i] - prev)))
            st.log.append(BilevelLogEntry(
                i + 1, float(res.times[i]), float(c), float(gnorms[i]),
                float("nan"), step_norm))
    g_norm = float(gnorms[-1]) if len(gnorms) else float("nan")
    return st, g_norm


def run_single_loop(params, device, learn, **extra) -> BilevelResult:
    """A single-loop first-order learner behind the experiment surface
    (the JAX package's ``_run_single_loop`` and its families'
    ``_run_*_single_loop``): ``learn(utrue, f, x0, **kw)`` is one of the
    ``single_loop_*_learn`` functions, run in ``single_loop_log_every(
    outer)`` segments (``log_every`` in params is not read, as in the JAX
    package) with the ``sl_*`` knobs and ``extra``."""
    _reject_flags(params, "single_loop",
                  ("checkpoint", "resume", "save_iterations", "inner_tol"))
    reject_unported(params, allow=("log_every",))
    ds = _load(params, device)
    outer = int(params.sl_outer)
    res = learn(ds[0], ds[1], np.asarray(params.alpha0), outer=outer,
                n_inner=int(params.sl_inner), n_adj=int(params.sl_adj),
                lr=float(params.sl_lr),
                log_every=single_loop_log_every(outer), **extra)
    st, g_norm = single_loop_state(res, params.alpha0)
    return BilevelResult(x=res.alpha.cpu().numpy(), u=res.u.cpu().numpy(),
                         state=st, cost=float(res.cost), g_norm=g_norm,
                         iterations=outer)


def _run_single_loop(params, model_kind, device):
    model = tv_model() if model_kind == "tv" else sumregs_model()
    return run_single_loop(
        params, device,
        lambda ut, f, x0, **kw: single_loop_learn(ut, f, x0, model, **kw))


def _params(family_params, visualise, kwargs):
    if visualise:
        raise NotImplementedError(VISUALISE_REFUSAL)
    params = merge(default_params, family_params, kwargs)
    return params | dict(dataset_name=full_datasetname(params.dataset_name))


def _run_method(params, model_kind, device):
    """``method="tr"`` (the host trust region), ``"tr_fused"`` or
    ``"single_loop"``."""
    method = params.get("method")
    if method == "single_loop":
        return _run_single_loop(params, model_kind, device)
    if method == "tr_fused":
        return _run_fused(params, model_kind, device)
    if method == "tr":
        factory = (make_tv_learning_function if model_kind == "tv"
                   else make_sumregs_learning_function)
        return run_bilevel(params, _make_lf(params, factory, device), device)
    raise ValueError(f"method must be 'tr' (host trust region), 'tr_fused' "
                     f"(the fused loop) or 'single_loop' (first-order), got "
                     f"{method!r}")


def scalar_bilevel_tv_learn(visualise: bool = False, device="cuda",
                            **kwargs) -> BilevelResult:
    """Learn one scalar TV weight on a dataset with the host trust region
    (``method="tr"``, the default), the fused one (``method="tr_fused"``)
    or the single-loop learner (``method="single_loop"``).
    ``device="cuda"`` runs the CUDA kernels; ``device="cpu"`` runs their
    plain versions.
    """
    params = _params(bilevel_params, visualise, kwargs)
    return _run_method(params, "tv", device)


def patch_bilevel_tv_learn(visualise: bool = False, device="cuda",
                           **kwargs) -> BilevelResult:
    """Learn an (m, n) patch grid of TV weights (default 2×2 from 1e-4)
    with either trust region or the single-loop learner."""
    params = _params(patch_bilevel_params, visualise, kwargs)
    return _run_method(params, "tv", device)


def scalar_bilevel_sumregs_learn(visualise: bool = False, device="cuda",
                                 **kwargs) -> BilevelResult:
    """Learn the (3,) weights of the forward, backward and centred TV terms
    (default 1e-3 each) with either trust region or the single-loop
    learner."""
    params = _params(sumregs_bilevel_params, visualise, kwargs)
    return _run_method(params, "sumregs", device)


def patch_bilevel_sumregs_learn(image_pair=None, dataset_name=None,
                                visualise: bool = False, device="cuda",
                                **kwargs) -> BilevelResult:
    """Learn an (m, n, 3) patch stack of sum-of-regularizers weights
    (default 2×2×3 from 1e-3, β₂ = 1.5) with either trust region or the
    single-loop learner, on ``dataset_name``; or, given
    ``image_pair=(true_image, noisy_image)``, on that one (M, N) pair (a
    1 × M × N stack in the params dtype) with the host trust region, which
    that form runs whatever ``method`` says, as in the JAX package."""
    if dataset_name is not None:
        kwargs = dict(kwargs, dataset_name=dataset_name)
    params = _params(patch_sumregs_bilevel_params, visualise, kwargs)
    if image_pair is None:
        return _run_method(params, "sumregs", device)
    dt = getattr(torch, str(params.get("dtype", "float64")))
    ds = tuple(torch.as_tensor(np.asarray(im), dtype=dt)[None].to(device)
               for im in image_pair[:2])
    lf = _make_lf(params, make_sumregs_learning_function, device)
    return run_bilevel(params, lf, device, ds=ds)
