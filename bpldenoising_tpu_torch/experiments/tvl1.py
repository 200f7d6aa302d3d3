"""TV-L1 experiment front-ends (counterpart of
``bpldenoising_tpu.experiments.tvl1``).

The robust L1 data term for impulse (salt-and-pepper) noise:
:func:`TVL1Denoise` (plain TV-L1 at a fixed scalar α, (M, N) map or (m, n)
patch grid), :func:`validate_tvl1_parameter` (its budget
``inner_maxiter``, 10,000 by :data:`tvl1_params`), the α sweep
:func:`generate_tvl1_cost` with its plot, and the bilevel learns
:func:`scalar_bilevel_tvl1_learn` and :func:`patch_bilevel_tvl1_learn` on
the Huber-smoothed surrogate, with ``method="tr"`` (the default: the host
trust region over :func:`..learning.tvl1.make_tvl1_learning_function`),
``method="tr_fused"`` (the fused trust region) or
``method="single_loop"`` (the first-order learner of
:mod:`..bilevel.first_order_tvl1`), each ending in
:func:`.api.save_results` (the true and noisy images stretched, as in the
JAX package).  As in the TV and TGV entry points, ``check_every`` (the
inner early-stop cadence) is a parameter; ``checkpoint``, ``resume``,
``save_iterations`` and ``log_every`` run as in the TV entry point
(:func:`.api.run_fused`, :func:`.api.run_bilevel`); ``data_parallel=True``
runs :func:`..parallel.sharded.make_sharded_tvl1_learning_function` with
``method="tr"`` and a mesh with ``"tr_fused"`` (:func:`.api.run_fused`), as
in the JAX package; any ``backend`` but ``"auto"`` raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..bilevel.first_order_tvl1 import single_loop_tvl1_learn
from ..bilevel.fused_tvl1 import bilevel_learn_tvl1_fused
from ..bilevel.harness import BilevelResult
from ..data import testdataset
from ..learning.tvl1 import make_tvl1_learning_function
from ..ops import PatchOp
from ..parallel import make_sharded_tvl1_learning_function
from ..solvers.tvl1 import tvl1_denoise
from ..utils.config import Params
from ..viz.plots import plot_cost_curve
from .api import (L2CostFunction, _host, _load, _out_dir, _plot_npz,
                  _sweep_params, _torch_dtype, check_backend,
                  data_parallel_mesh, experiment_params, finish_validation,
                  refuse_inner_tol, run_bilevel, run_fused, run_single_loop)

__all__ = ["TVL1Denoise", "validate_tvl1_parameter", "generate_tvl1_cost",
           "generate_tvl1_cost_plot", "tvl1_params",
           "scalar_bilevel_tvl1_learn", "patch_bilevel_tvl1_learn",
           "tvl1_bilevel_params", "patch_tvl1_bilevel_params"]

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


def _cg_kwargs(params):
    """Optional adjoint-CG accuracy overrides (``cg_tol``,
    ``cg_maxiter``)."""
    kw = {}
    if params.get("cg_tol") is not None:
        kw["cg_tol"] = float(params.cg_tol)
    if params.get("cg_maxiter") is not None:
        kw["cg_maxiter"] = int(params.cg_maxiter)
    return kw


def _learn(params, visualise, device):
    """The learn by ``params.method``; the true and noisy images are
    stretched for the saved results in every method, as in the JAX
    package."""
    _check_method(params)
    huber = dict(gamma_d=float(params.tvl1_gamma_d),
                 gamma=float(params.tvl1_gamma))
    if params.method == "single_loop":
        return run_single_loop(params, device, single_loop_tvl1_learn,
                               stretch_all=True, **huber)
    if params.method == "tr_fused":
        return run_fused(params, device, bilevel_learn_tvl1_fused,
                         stretch_all=True, **huber, **_cg_kwargs(params))
    if params.get("data_parallel"):
        refuse_inner_tol(params)
        lf = make_sharded_tvl1_learning_function(
            data_parallel_mesh(device), maxiter=int(params.inner_maxiter),
            **huber, **_cg_kwargs(params))
        return run_bilevel(params, lf, device, visualise=visualise,
                           stretch_all=True)
    # the JAX entry point's learning-function keywords (its _tvl1_lf)
    lf_kwargs = dict(maxiter=int(params.inner_maxiter),
                     check_every=int(params.check_every), device=device,
                     **huber, **_cg_kwargs(params))
    if params.get("inner_tol") is not None:
        lf_kwargs["tol"] = float(params.inner_tol)
    return run_bilevel(params, make_tvl1_learning_function(**lf_kwargs),
                       device, visualise=visualise, stretch_all=True)


def scalar_bilevel_tvl1_learn(visualise: bool = False, device="cuda",
                              **kwargs) -> BilevelResult:
    """Learn the scalar TV-L1 weight on the Huber-smoothed surrogate by the
    host trust region (``method="tr"``, the default), the fused one
    (``method="tr_fused"``) or the single-loop learner
    (``method="single_loop"``).  ``device="cuda"`` runs the CUDA kernels;
    ``device="cpu"`` runs their plain versions."""
    params = experiment_params(tvl1_bilevel_params, kwargs,
                               "tvl1_optimal_parameter_scalar_")
    return _learn(params, visualise, device)


def patch_bilevel_tvl1_learn(visualise: bool = False, device="cuda",
                             **kwargs) -> BilevelResult:
    """Learn a spatially-varying (m, n) TV-L1 weight grid by either trust
    region or the single-loop learner; the learned grid is saved as a
    stretched parameter map."""
    params = experiment_params(patch_tvl1_bilevel_params, kwargs,
                               "tvl1_optimal_parameter_{shape}_")
    return _learn(params, visualise, device)


def validate_tvl1_parameter(parameter, device="cuda", **kwargs):
    """:func:`TVL1Denoise` of the whole dataset at a fixed α (scalar, map
    or grid) for ``inner_maxiter`` iterations (10,000 by
    :data:`tvl1_params`), on ``device``; the quality table and the PNG
    triplets under ``output/<dataset>/val_tvl1_…``.  Returns
    ``dict(cost, mean_ssim, mean_psnr, u)``."""
    params = experiment_params(tvl1_params, kwargs,
                               "val_tvl1_optimal_parameter_{shape}_",
                               parameter)
    img, noisy = testdataset(params.dataset_name)
    u = _host(TVL1Denoise(torch.as_tensor(noisy, dtype=_torch_dtype(params)),
                          parameter, maxiter=int(params.inner_maxiter),
                          device=device))
    return finish_validation(params, parameter, u, img, noisy)


def generate_tvl1_cost(dataset_name, parameter_range, *, num_samples=1,
                       maxiter=5000, dtype="float64", device="cuda"):
    """The cost ½‖u − ū‖² over plain TV-L1 weights α: one cold
    ``maxiter``-iteration solve per α; saved to ``<ds>_tvl1_cost.npz``
    (``parameter_range``, ``costs``)."""
    params = _sweep_params(dataset_name, num_samples, dtype)
    true_, data = _load(params, device)
    costs = np.asarray(
        [L2CostFunction(tvl1_denoise(data, float(a), maxiter=maxiter), true_)
         for a in np.asarray(parameter_range, np.float64)],
        dtype=np.dtype(params.dtype))
    out = _out_dir(params)
    np.savez(os.path.join(out, f"{params.dataset_name}_tvl1_cost.npz"),
             parameter_range=np.asarray(parameter_range), costs=costs)
    return costs


def generate_tvl1_cost_plot(dataset_name):
    """Log-log plot of the α sweep."""
    return _plot_npz(dataset_name, "_tvl1_cost", "_tvl1_cost_plot",
                     plot_cost_curve, title="TV-L1 Scalar Cost")
