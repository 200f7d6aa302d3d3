"""TV-L1 experiment front-ends (counterpart of
``bpldenoising_tpu.experiments.tvl1``).

The robust L1 data term for impulse (salt-and-pepper) noise.  Ported so
far: :func:`TVL1Denoise` (plain TV-L1 at a fixed scalar α, (M, N) map or
(m, n) patch grid) and the bilevel learns :func:`scalar_bilevel_tvl1_learn`
and :func:`patch_bilevel_tvl1_learn` on the Huber-smoothed surrogate, with
``method="tr_fused"`` (the trust region) or ``method="single_loop"`` (the
first-order learner of :mod:`..bilevel.first_order_tvl1`).  As in the TV
and TGV entry points, ``check_every`` (the inner early-stop cadence) is a
parameter; the ``tr`` method, saving results, visualisation,
checkpointing, segmented dispatch of the trust region (``log_every``) and
data parallelism raise ``NotImplementedError``, as does any ``backend``
but ``"auto"``.  Validation and the cost sweep need SSIM and the results
code, which are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bilevel.first_order_tvl1 import single_loop_tvl1_learn
from ..bilevel.fused_tvl1 import bilevel_learn_tvl1_fused
from ..data import full_datasetname
from ..ops import PatchOp
from ..solvers.tvl1 import tvl1_denoise
from ..utils.config import Params, merge
from ..bilevel.harness import BilevelResult
from .api import (_fused_to_result, _load, check_backend, default_params,
                  reject_unported, run_single_loop)

__all__ = ["TVL1Denoise", "tvl1_params", "scalar_bilevel_tvl1_learn",
           "patch_bilevel_tvl1_learn", "tvl1_bilevel_params",
           "patch_tvl1_bilevel_params"]

# TV-L1 weights live on an O(1) scale (the data term is ‖·‖₁, not ½‖·‖²);
# validation uses the 10000-iteration budget
tvl1_params = Params(alpha0=1.0, inner_maxiter=10000)

# the JAX package's TR schedule for the TV-L1 weight on its impulse-noise
# dataset, with the data / regularizer Huber slopes of the smoothed
# surrogate.  check_every=500 is the inner early-stop cadence the JAX entry
# point runs (it passes none, so bilevel_learn_tvl1_fused's default
# applies).
tvl1_bilevel_params = Params(
    eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.1, alpha0=0.4,
    dataset_name="circle_sp_128_20", tvl1_gamma_d=100.0, tvl1_gamma=1000.0,
    check_every=500)

patch_tvl1_bilevel_params = tvl1_bilevel_params | Params(
    delta0=0.1, alpha0=0.4 * np.ones((2, 2)))


def TVL1Denoise(data, parameter, maxiter: int = 10000, backend="auto",
                device="cuda"):
    """Batched TV-L1 denoising of (O, M, N) / (M, N) stacks at a fixed
    scalar α, (M, N) map, or (m, n) patch grid, on ``device``
    (``backend`` follows :func:`.api.check_backend`)."""
    check_backend(backend)
    data = torch.as_tensor(data).to(device)
    p = np.asarray(parameter, np.float64)
    if p.ndim == 2 and p.shape != tuple(data.shape[-2:]):
        pop = PatchOp(tuple(p.shape), tuple(data.shape[-2:]))
        alpha = pop.apply(torch.as_tensor(p, dtype=data.dtype))
    elif p.ndim in (0, 2):
        alpha = torch.as_tensor(p, dtype=data.dtype)
    else:
        raise ValueError(f"TV-L1 parameter must be a scalar, (M, N) map "
                         f"or (m, n) patch grid, got shape {p.shape}")
    return tvl1_denoise(data, alpha, maxiter=maxiter)


def _check_method(params):
    m = params.get("method", "tr")
    if m not in (None, "tr", "tr_fused", "single_loop"):
        raise ValueError(f"TV-L1 experiments support method='tr' (host "
                         f"trust region), 'tr_fused' (one-dispatch "
                         f"on-device loop) or 'single_loop' (first-order), "
                         f"got {m!r}")
    if m not in ("tr_fused", "single_loop"):
        raise NotImplementedError(
            f"method={m!r} is not ported yet; use method='tr_fused' or "
            "'single_loop'")


def _cg_kwargs(params):
    """Optional adjoint-CG accuracy overrides (``cg_tol``,
    ``cg_maxiter``)."""
    kw = {}
    if params.get("cg_tol") is not None:
        kw["cg_tol"] = float(params.cg_tol)
    if params.get("cg_maxiter") is not None:
        kw["cg_maxiter"] = int(params.cg_maxiter)
    return kw


def _run_tvl1_fused(params, device):
    reject_unported(params)
    ds = _load(params, device)
    res = bilevel_learn_tvl1_fused(
        ds, xinit=np.asarray(params.alpha0), params=params,
        inner_maxiter=int(params.inner_maxiter),
        inner_tol=params.get("inner_tol"),
        check_every=int(params.check_every),
        gamma_d=float(params.tvl1_gamma_d), gamma=float(params.tvl1_gamma),
        device=device, **_cg_kwargs(params))
    return _fused_to_result(res)


def _learn(family_params, visualise, device, kwargs):
    if visualise:
        raise NotImplementedError("visualise is not ported yet")
    params = merge(default_params, family_params, kwargs)
    params = params | dict(dataset_name=full_datasetname(params.dataset_name))
    _check_method(params)
    if params.method == "single_loop":
        return run_single_loop(params, device, single_loop_tvl1_learn,
                               gamma_d=float(params.tvl1_gamma_d),
                               gamma=float(params.tvl1_gamma))
    return _run_tvl1_fused(params, device)


def scalar_bilevel_tvl1_learn(visualise: bool = False, device="cuda",
                              **kwargs) -> BilevelResult:
    """Learn the scalar TV-L1 weight on the Huber-smoothed surrogate by the
    trust region (``method="tr_fused"``) or the single-loop learner
    (``method="single_loop"``).  ``device="cuda"`` runs the CUDA kernels;
    ``device="cpu"`` runs their plain versions."""
    return _learn(tvl1_bilevel_params, visualise, device, kwargs)


def patch_bilevel_tvl1_learn(visualise: bool = False, device="cuda",
                             **kwargs) -> BilevelResult:
    """Learn a spatially-varying (m, n) TV-L1 weight grid by the trust
    region (``method="tr_fused"``) or the single-loop learner
    (``method="single_loop"``)."""
    return _learn(patch_tvl1_bilevel_params, visualise, device, kwargs)
