"""TGV² experiment front-ends (counterpart of
``bpldenoising_tpu.experiments.tgv``).

The parameter is the 2-vector (α₁, α₀) weighting the first- and
second-order terms, or an (m, n, 2) stack of patch grids.  Ported so far:
:func:`scalar_bilevel_tgv_learn` and :func:`patch_bilevel_tgv_learn` with
``method="tr"`` (the default: the host trust region over
:func:`..learning.tgv.make_tgv_learning_function`), ``method="tr_fused"``
and ``method="single_loop"`` (the first-order learner of
:mod:`..bilevel.first_order_tgv` at ``sl_lr`` 0.02, its log every
``sl_outer // 20`` steps), and :func:`TGVDenoise`.  As in the TV entry
point, ``check_every``, ``inner_tol`` and ``tgv_gamma`` are parameters;
saving results, validation (it needs SSIM), cost sweeps, checkpointing,
segmented dispatch of the trust region (``log_every``) and data
parallelism raise ``NotImplementedError``, as does any ``backend`` but
``"auto"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bilevel.first_order_tgv import single_loop_tgv_learn
from ..bilevel.fused_tgv import bilevel_learn_tgv_fused
from ..data import full_datasetname
from ..learning.tgv import make_tgv_learning_function
from ..ops import PatchOp
from ..solvers.tgv import tgv_denoise_pdps
from ..utils.config import Params, merge
from ..bilevel.harness import BilevelResult
from .api import (VISUALISE_REFUSAL, _fused_to_result, _load, check_backend,
                  default_params, reject_unported, run_bilevel,
                  run_single_loop)

__all__ = ["tgv_bilevel_params", "patch_tgv_bilevel_params",
           "scalar_bilevel_tgv_learn", "patch_bilevel_tgv_learn",
           "TGVDenoise"]

# the JAX package's TR schedule for the 2-vector weight; sl_lr is the
# single-loop learning rate that keeps that method from diverging on TGV.
# check_every=500 is the inner early-stop cadence the JAX entry point runs
# (it does not pass one, so bilevel_learn_tgv_fused's default applies).
tgv_bilevel_params = Params(
    eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.02,
    alpha0=np.array([0.05, 0.05]), sl_lr=0.02, check_every=500)

# patch analogue: an (m, n, 2) stack of (α₁, α₀) grids upsampled
# piecewise-constant
patch_tgv_bilevel_params = Params(
    eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.5, delta0=0.02,
    alpha0=0.05 * np.ones((2, 2, 2)), sl_lr=0.02, check_every=500)


def TGVDenoise(data, parameter, maxiter: int = 10000, backend="auto",
               device="cuda"):
    """Batched TGV² denoising at a fixed (α₁, α₀) pair or an (m, n, 2)
    patch-grid stack of spatially-varying weights, on ``device``
    (``backend`` follows :func:`.api.check_backend`)."""
    check_backend(backend)
    data = torch.as_tensor(data).to(device)
    p = np.asarray(parameter, np.float64)
    if p.ndim == 3 and p.shape[-1] == 2:   # patch grids → (M, N) maps
        pop = PatchOp.for_image(p[..., 0],
                                data[0] if data.ndim == 3 else data)
        a1 = pop.apply(torch.as_tensor(p[..., 0], dtype=data.dtype))
        a0 = pop.apply(torch.as_tensor(p[..., 1], dtype=data.dtype))
    elif p.reshape(-1).size == 2:
        a1, a0 = float(p.reshape(-1)[0]), float(p.reshape(-1)[1])
    else:
        raise ValueError(f"TGV parameter must be (alpha1, alpha0) or an "
                         f"(m, n, 2) patch stack, got {np.shape(parameter)}")
    u, _ = tgv_denoise_pdps(data, a1, a0, maxiter=maxiter)
    return u


def _run_tgv_fused(params, device):
    reject_unported(params)
    ds = _load(params, device)
    res = bilevel_learn_tgv_fused(
        ds, xinit=np.asarray(params.alpha0), params=params,
        inner_maxiter=int(params.inner_maxiter),
        inner_tol=params.get("inner_tol"),
        check_every=int(params.check_every),
        gamma=_tgv_gamma(params), device=device)
    return _fused_to_result(res)


def _tgv_gamma(params) -> float:
    return (1e-4 if params.get("tgv_gamma") is None
            else float(params.tgv_gamma))


def _learn(family_params, visualise, device, kwargs):
    if visualise:
        raise NotImplementedError(VISUALISE_REFUSAL)
    params = merge(default_params, family_params, kwargs)
    params = params | dict(dataset_name=full_datasetname(params.dataset_name))
    if params.get("method") == "single_loop":
        return run_single_loop(params, device, single_loop_tgv_learn,
                               gamma=_tgv_gamma(params))
    if params.get("method") == "tr_fused":
        return _run_tgv_fused(params, device)
    if params.get("method") != "tr":
        raise ValueError(f"TGV experiments support method='tr' (host trust "
                         f"region), 'tr_fused' or 'single_loop', got "
                         f"{params.get('method')!r}")
    # the JAX entry point's learning-function keywords
    lf_kwargs = dict(maxiter=int(params.inner_maxiter),
                     gamma=_tgv_gamma(params),
                     check_every=int(params.check_every), device=device)
    if params.get("inner_tol") is not None:
        lf_kwargs["tol"] = float(params.inner_tol)
    return run_bilevel(params, make_tgv_learning_function(**lf_kwargs),
                       device)


def scalar_bilevel_tgv_learn(visualise: bool = False, device="cuda",
                             **kwargs) -> BilevelResult:
    """Learn (α₁, α₀) by the host trust region (``method="tr"``, the
    default), the fused one (``method="tr_fused"``) or the single-loop
    learner (``method="single_loop"``).  ``device="cuda"`` runs the CUDA
    kernels; ``device="cpu"`` runs their plain versions."""
    return _learn(tgv_bilevel_params, visualise, device, kwargs)


def patch_bilevel_tgv_learn(visualise: bool = False, device="cuda",
                            **kwargs) -> BilevelResult:
    """Learn spatially-varying (α₁, α₀) patch grids (an (m, n, 2) stack)
    by either trust region or the single-loop learner."""
    return _learn(patch_tgv_bilevel_params, visualise, device, kwargs)
