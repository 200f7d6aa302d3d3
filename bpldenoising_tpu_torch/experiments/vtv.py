"""Vectorial (color) TV experiment front-ends (counterpart of
``bpldenoising_tpu.experiments.vtv``).

Datasets load as planar (O, 3, M, N) color stacks
(``testdataset(name, color=True)``) and the learned parameter is a scalar
coupling weight α or an (m, n) patch grid.  Ported so far:
:func:`VTVDenoise` (a scalar α, (M, N) map or (m, n) patch grid) and the
bilevel learns :func:`scalar_bilevel_vtv_learn` and
:func:`patch_bilevel_vtv_learn` with ``method="tr"`` (the default: the
host trust region over :func:`..learning.vtv.make_vtv_learning_function`),
``method="tr_fused"`` (the fused trust region) or
``method="single_loop"`` (the first-order learner of
:mod:`..bilevel.first_order_vtv`).  As in the other families' entry
points, ``check_every``, ``inner_tol`` and ``vtv_gamma`` are parameters;
saving results, visualisation, checkpointing, segmented dispatch of the
trust region (``log_every``) and data parallelism raise
``NotImplementedError``, as does any ``backend`` but ``"auto"``.  Validation and the cost sweeps need SSIM
and the results code, which are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bilevel.first_order_vtv import single_loop_vtv_learn
from ..bilevel.fused_vtv import bilevel_learn_vtv_fused
from ..bilevel.harness import BilevelResult
from ..data import full_datasetname
from ..learning.vtv import make_vtv_learning_function
from ..ops import PatchOp
from ..solvers.pdps import vtv_denoise
from ..utils.config import Params, merge
from .api import (VISUALISE_REFUSAL, _fused_to_result, _load, check_backend,
                  default_params, reject_unported, run_bilevel,
                  run_single_loop)

__all__ = ["vtv_bilevel_params", "patch_vtv_bilevel_params",
           "scalar_bilevel_vtv_learn", "patch_bilevel_vtv_learn",
           "VTVDenoise"]

# the JAX package's TR schedule for the coupling weight; color=True routes
# _load through the planar color reader.  check_every=500 is the inner
# early-stop cadence the JAX entry point runs (it passes none, so
# bilevel_learn_vtv_fused's default applies).
vtv_bilevel_params = Params(
    eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.02,
    alpha0=0.05, color=True, check_every=500)

# patch analogue: an (m, n) grid upsampled piecewise-constant
patch_vtv_bilevel_params = Params(
    eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.5, delta0=0.02,
    alpha0=0.05 * np.ones((2, 2)), color=True, check_every=500)


def VTVDenoise(data, parameter, maxiter: int = 10000, backend="auto",
               device="cuda"):
    """Batched vectorial-TV denoising of planar (O, 3, M, N) / (3, M, N)
    color stacks at a fixed scalar α, (M, N) map, or (m, n) patch grid, on
    ``device`` (``backend`` follows :func:`.api.check_backend`)."""
    check_backend(backend)
    data = torch.as_tensor(data).to(device)
    p = np.asarray(parameter, np.float64)
    if p.ndim == 2 and p.shape != tuple(data.shape[-2:]):
        pop = PatchOp(tuple(p.shape), tuple(data.shape[-2:]))
        alpha = pop.apply(torch.as_tensor(p, dtype=data.dtype))
    elif p.ndim in (0, 2):
        alpha = torch.as_tensor(p, dtype=data.dtype)
    else:
        raise ValueError(f"VTV parameter must be a scalar, (M, N) map or "
                         f"(m, n) patch grid, got shape {p.shape}")
    return vtv_denoise(data, alpha, maxiter=maxiter)


def _check_method(params):
    m = params.get("method", "tr")
    if m not in (None, "tr", "tr_fused", "single_loop"):
        raise ValueError(f"VTV experiments support method='tr' (host trust "
                         f"region), 'tr_fused' (one-dispatch on-device "
                         f"loop) or 'single_loop' (first-order), got {m!r}")


def _run_vtv_fused(params, device):
    reject_unported(params)
    ds = _load(params, device)
    res = bilevel_learn_vtv_fused(
        ds, xinit=np.asarray(params.alpha0), params=params,
        inner_maxiter=int(params.inner_maxiter),
        inner_tol=params.get("inner_tol"),
        check_every=int(params.check_every),
        gamma=_vtv_gamma(params), device=device)
    return _fused_to_result(res)


def _vtv_gamma(params) -> float:
    return (1e-4 if params.get("vtv_gamma") is None
            else float(params.vtv_gamma))


def _learn(family_params, visualise, device, kwargs):
    if visualise:
        raise NotImplementedError(VISUALISE_REFUSAL)
    params = merge(default_params, family_params, kwargs)
    params = params | dict(dataset_name=full_datasetname(params.dataset_name))
    _check_method(params)
    if params.method == "single_loop":
        return run_single_loop(params, device, single_loop_vtv_learn,
                               gamma=_vtv_gamma(params))
    if params.method == "tr_fused":
        return _run_vtv_fused(params, device)
    # the JAX entry point's learning-function keywords
    lf_kwargs = dict(maxiter=int(params.inner_maxiter),
                     gamma=_vtv_gamma(params),
                     check_every=int(params.check_every), device=device)
    if params.get("inner_tol") is not None:
        lf_kwargs["tol"] = float(params.inner_tol)
    return run_bilevel(params, make_vtv_learning_function(**lf_kwargs),
                       device)


def scalar_bilevel_vtv_learn(visualise: bool = False, device="cuda",
                             **kwargs) -> BilevelResult:
    """Learn the scalar coupling weight α on color data by the host trust
    region (``method="tr"``, the default), the fused one
    (``method="tr_fused"``) or the single-loop learner
    (``method="single_loop"``).  ``device="cuda"`` runs the CUDA kernels;
    ``device="cpu"`` runs their plain versions."""
    return _learn(vtv_bilevel_params, visualise, device, kwargs)


def patch_bilevel_vtv_learn(visualise: bool = False, device="cuda",
                            **kwargs) -> BilevelResult:
    """Learn a spatially-varying (m, n) coupling-weight grid on color data
    by either trust region or the single-loop learner."""
    return _learn(patch_vtv_bilevel_params, visualise, device, kwargs)
