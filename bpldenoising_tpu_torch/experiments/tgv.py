"""TGV² experiment front-ends (counterpart of
``bpldenoising_tpu.experiments.tgv``).

The parameter is the 2-vector (α₁, α₀) weighting the first- and
second-order terms, or an (m, n, 2) stack of patch grids.
:func:`scalar_bilevel_tgv_learn` and :func:`patch_bilevel_tgv_learn` run
``method="tr"`` (the default: the host trust region over
:func:`..learning.tgv.make_tgv_learning_function`), ``method="tr_fused"``
and ``method="single_loop"`` (the first-order learner of
:mod:`..bilevel.first_order_tgv` at ``sl_lr`` 0.02, its log every
``sl_outer // 20`` steps), each ending in :func:`.api.save_results` (the
true and noisy images stretched, as in the JAX package).  Also here:
:func:`TGVDenoise`, :func:`validate_tgv_parameter` and the (α₁, α₀) cost
sweep :func:`generate_tgv_cost` with its plot.  As in the TV entry point,
``check_every``, ``inner_tol`` and ``tgv_gamma`` are parameters;
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

from ..bilevel.first_order_tgv import single_loop_tgv_learn
from ..bilevel.fused_tgv import bilevel_learn_tgv_fused
from ..bilevel.harness import BilevelResult
from ..data import testdataset
from ..learning.tgv import make_tgv_learning_function
from ..ops import PatchOp
from ..solvers.tgv import tgv_denoise_pdps
from ..utils.config import Params
from ..viz.plots import plot_cost_contour
from .api import (L2CostFunction, _host, _load, _out_dir, _plot_npz,
                  _sweep_params, _torch_dtype, check_backend,
                  experiment_params, finish_validation, run_bilevel,
                  run_fused, run_single_loop)

__all__ = ["tgv_bilevel_params", "patch_tgv_bilevel_params",
           "scalar_bilevel_tgv_learn", "patch_bilevel_tgv_learn",
           "generate_tgv_cost", "generate_tgv_cost_plot",
           "validate_tgv_parameter", "TGVDenoise"]

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


def _tgv_gamma(params) -> float:
    return (1e-4 if params.get("tgv_gamma") is None
            else float(params.tgv_gamma))


def _learn(params, visualise, device):
    """The learn by ``params.method``; the true and noisy images are
    stretched for the saved results in every method, as in the JAX
    package."""
    if params.get("method") == "single_loop":
        return run_single_loop(params, device, single_loop_tgv_learn,
                               stretch_all=True, gamma=_tgv_gamma(params))
    if params.get("method") == "tr_fused":
        return run_fused(params, device, bilevel_learn_tgv_fused,
                         stretch_all=True, gamma=_tgv_gamma(params))
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
                       device, visualise=visualise, stretch_all=True)


def scalar_bilevel_tgv_learn(visualise: bool = False, device="cuda",
                             **kwargs) -> BilevelResult:
    """Learn (α₁, α₀) by the host trust region (``method="tr"``, the
    default), the fused one (``method="tr_fused"``) or the single-loop
    learner (``method="single_loop"``).  ``device="cuda"`` runs the CUDA
    kernels; ``device="cpu"`` runs their plain versions."""
    params = experiment_params(tgv_bilevel_params, kwargs,
                               "tgv_optimal_parameter_")
    return _learn(params, visualise, device)


def patch_bilevel_tgv_learn(visualise: bool = False, device="cuda",
                            **kwargs) -> BilevelResult:
    """Learn spatially-varying (α₁, α₀) patch grids (an (m, n, 2) stack)
    by either trust region or the single-loop learner; the learned stack
    is saved as two stretched parameter maps."""
    params = experiment_params(patch_tgv_bilevel_params, kwargs,
                               "tgv_optimal_parameter_patch_{shape}_")
    return _learn(params, visualise, device)


def generate_tgv_cost(dataset_name, parameter_range_1, parameter_range_2,
                      *, num_samples=1, maxiter=5000, dtype="float64",
                      device="cuda"):
    """The cost ½‖u − ū‖² over TGV² weight pairs (α₁, α₀): one cold
    ``maxiter``-iteration solve per pair; saved to ``<ds>_tgv_cost_2d.npz``
    (``parameter_range_1``, ``parameter_range_2``, ``costs``)."""
    params = _sweep_params(dataset_name, num_samples, dtype)
    true_, data = _load(params, device)
    r1 = np.asarray(parameter_range_1, dtype=np.float64)
    r2 = np.asarray(parameter_range_2, dtype=np.float64)
    A1, A0 = np.meshgrid(r1, r2, indexing="ij")
    costs = np.asarray(
        [L2CostFunction(tgv_denoise_pdps(data, float(a1), float(a0),
                                      maxiter=maxiter)[0], true_)
         for a1, a0 in zip(A1.ravel(), A0.ravel())],
        dtype=np.dtype(params.dtype)).reshape(A1.shape)
    out = _out_dir(params)
    np.savez(os.path.join(out, f"{params.dataset_name}_tgv_cost_2d.npz"),
             parameter_range_1=r1, parameter_range_2=r2, costs=costs)
    return costs


def generate_tgv_cost_plot(dataset_name):
    """Contour plot of the (α₁, α₀) sweep."""
    return _plot_npz(dataset_name, "_tgv_cost_2d", "_tgv_cost_plot_2d",
                     plot_cost_contour)


def validate_tgv_parameter(parameter, device="cuda", **kwargs):
    """:func:`TGVDenoise` of the whole dataset at a fixed (α₁, α₀) (or
    patch stack), 10,000 iterations, on ``device``; the quality table and
    the PNG triplets under ``output/<dataset>/val_tgv_…``.  Returns
    ``dict(cost, mean_ssim, mean_psnr, u)``."""
    params = experiment_params(tgv_bilevel_params, kwargs,
                               "val_tgv_optimal_parameter_{shape}_", parameter)
    img, noisy = testdataset(params.dataset_name)
    u = _host(TGVDenoise(torch.as_tensor(noisy, dtype=_torch_dtype(params)),
                         parameter, device=device))
    return finish_validation(params, parameter, u, img, noisy)
