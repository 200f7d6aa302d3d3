"""Vectorial (color) TV experiment front-ends (counterpart of
``bpldenoising_tpu.experiments.vtv``).

Datasets load as planar (O, 3, M, N) color stacks
(``testdataset(name, color=True)``) and the learned parameter is a scalar
coupling weight α or an (m, n) patch grid.  :func:`VTVDenoise` (a scalar
α, (M, N) map or (m, n) patch grid), :func:`validate_vtv_parameter`, the
α sweep :func:`generate_vtv_cost` with its plot, and the bilevel learns
:func:`scalar_bilevel_vtv_learn` and :func:`patch_bilevel_vtv_learn` with
``method="tr"`` (the default: the host trust region over
:func:`..learning.vtv.make_vtv_learning_function`),
``method="tr_fused"`` (the fused trust region) or
``method="single_loop"`` (the first-order learner of
:mod:`..bilevel.first_order_vtv`), each ending in
:func:`.api.save_results` with RGB PNG triplets (only the reconstruction
stretched, as in the JAX package).  As in the other families' entry
points, ``check_every``, ``inner_tol`` and ``vtv_gamma`` are parameters;
``checkpoint``, ``resume``, ``save_iterations`` and ``log_every`` run as
in the TV entry point (:func:`.api.run_fused`, :func:`.api.run_bilevel`);
``data_parallel=True`` gives ``method="tr_fused"`` a mesh
(:func:`.api.run_fused`) and is not read by ``method="tr"``, as in the JAX
package (its host trust region takes the unsharded learning function);
any ``backend`` but ``"auto"`` raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..bilevel.first_order_vtv import single_loop_vtv_learn
from ..bilevel.fused_vtv import bilevel_learn_vtv_fused
from ..bilevel.harness import BilevelResult
from ..data import testdataset
from ..learning.vtv import make_vtv_learning_function
from ..ops import PatchOp
from ..solvers.pdps import vtv_denoise
from ..utils.config import Params
from ..viz.plots import plot_cost_curve
from .api import (L2CostFunction, _host, _load, _out_dir, _plot_npz,
                  _sweep_params, _torch_dtype, check_backend,
                  experiment_params, finish_validation, run_bilevel,
                  run_fused, run_single_loop)

__all__ = ["vtv_bilevel_params", "patch_vtv_bilevel_params",
           "scalar_bilevel_vtv_learn", "patch_bilevel_vtv_learn",
           "generate_vtv_cost", "generate_vtv_cost_plot",
           "validate_vtv_parameter", "VTVDenoise"]

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


def _vtv_gamma(params) -> float:
    return (1e-4 if params.get("vtv_gamma") is None
            else float(params.vtv_gamma))


def _learn(params, visualise, device):
    """The learn by ``params.method``; only the reconstruction is
    stretched for the saved results, as in the JAX package."""
    _check_method(params)
    if params.method == "single_loop":
        return run_single_loop(params, device, single_loop_vtv_learn,
                               gamma=_vtv_gamma(params))
    if params.method == "tr_fused":
        return run_fused(params, device, bilevel_learn_vtv_fused,
                         gamma=_vtv_gamma(params))
    # the JAX entry point's learning-function keywords
    lf_kwargs = dict(maxiter=int(params.inner_maxiter),
                     gamma=_vtv_gamma(params),
                     check_every=int(params.check_every), device=device)
    if params.get("inner_tol") is not None:
        lf_kwargs["tol"] = float(params.inner_tol)
    return run_bilevel(params, make_vtv_learning_function(**lf_kwargs),
                       device, visualise=visualise)


def scalar_bilevel_vtv_learn(visualise: bool = False, device="cuda",
                             **kwargs) -> BilevelResult:
    """Learn the scalar coupling weight α on color data by the host trust
    region (``method="tr"``, the default), the fused one
    (``method="tr_fused"``) or the single-loop learner
    (``method="single_loop"``).  ``device="cuda"`` runs the CUDA kernels;
    ``device="cpu"`` runs their plain versions."""
    params = experiment_params(vtv_bilevel_params, kwargs,
                               "vtv_optimal_parameter_scalar_")
    return _learn(params, visualise, device)


def patch_bilevel_vtv_learn(visualise: bool = False, device="cuda",
                            **kwargs) -> BilevelResult:
    """Learn a spatially-varying (m, n) coupling-weight grid on color data
    by either trust region or the single-loop learner; the learned grid is
    saved as a stretched parameter map."""
    params = experiment_params(patch_vtv_bilevel_params, kwargs,
                               "vtv_optimal_parameter_patch_{shape}_")
    return _learn(params, visualise, device)


def generate_vtv_cost(dataset_name, parameter_range, *, num_samples=1,
                      maxiter=5000, dtype="float64", device="cuda"):
    """The cost ½‖u − ū‖² over the scalar coupling weight α on color data:
    one cold ``maxiter``-iteration solve per α; saved to
    ``<ds>_vtv_cost.npz`` (``parameter_range``, ``costs``)."""
    params = _sweep_params(dataset_name, num_samples, dtype, color=True)
    true_, data = _load(params, device)
    costs = np.asarray(
        [L2CostFunction(vtv_denoise(data, float(a), maxiter=maxiter), true_)
         for a in np.asarray(parameter_range, np.float64)],
        dtype=np.dtype(params.dtype))
    out = _out_dir(params)
    np.savez(os.path.join(out, f"{params.dataset_name}_vtv_cost.npz"),
             parameter_range=np.asarray(parameter_range), costs=costs)
    return costs


def generate_vtv_cost_plot(dataset_name):
    """Log-log plot of the α sweep."""
    return _plot_npz(dataset_name, "_vtv_cost", "_vtv_cost_plot",
                     plot_cost_curve)


def validate_vtv_parameter(parameter, device="cuda", **kwargs):
    """:func:`VTVDenoise` of the whole color dataset at a fixed α, 10,000
    iterations, on ``device``; the quality table (SSIM the mean over the
    channels) and RGB PNG triplets under ``output/<dataset>/val_vtv_…``.
    Returns ``dict(cost, mean_ssim, mean_psnr, u)``."""
    params = experiment_params(vtv_bilevel_params, kwargs,
                               "val_vtv_optimal_parameter_{shape}_", parameter)
    img, noisy = testdataset(params.dataset_name, color=True)
    u = _host(VTVDenoise(torch.as_tensor(noisy, dtype=_torch_dtype(params)),
                         parameter, device=device))
    return finish_validation(params, parameter, u, img, noisy)
