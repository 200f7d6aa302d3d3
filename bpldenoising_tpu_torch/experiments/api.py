"""User-facing experiment API (counterpart of
``bpldenoising_tpu.experiments.api``).

The learns :func:`scalar_bilevel_tv_learn`, :func:`patch_bilevel_tv_learn`,
:func:`scalar_bilevel_sumregs_learn` and :func:`patch_bilevel_sumregs_learn`
(its dataset and ``image_pair=`` forms) with ``method="tr"`` (the default:
the host-driven trust region of :mod:`..bilevel.trust_region` over the
learning functions of :mod:`..learning`, the shape of the JAX package's
``_make_lf`` and ``_run_bilevel``; the ``image_pair=`` form runs only this
method, as in the JAX package), ``method="tr_fused"`` (the shape of
``_run_fused``) and ``method="single_loop"`` (the shape of
``_run_single_loop``: the first-order learner in ``log_every = outer //
20`` segments, whose log carries real segment-end times).

Every learn ends in :func:`save_results` (``save_results=True`` by
default, as in the JAX package): under ``output/<dataset>/`` the
per-iteration log ``<prefix>.txt``, the per-image SSIM/PSNR table
``<prefix>_quality.txt``, the ``_true_i``/``_data_i``/``_reco_i`` PNGs and,
for patch parameters, the ``_par*.png`` maps, with the JAX package's
prefixes.  Also here: :func:`TVDenoise`, :func:`L2CostFunction`, the
validations :func:`validate_tv_parameter` and
:func:`validate_sumregs_parameter`, and the cost sweeps
:func:`generate_scalar_tv_cost` and :func:`generate_2d_tv_cost` with their
plots.  A sweep runs one cold fixed-budget solve per weight (or pair), as
kernel A takes one weight for a whole batch.

``checkpoint=True`` saves ``<prefix>_ckpt.npz`` under the output
directory after every accepted iteration (``method="tr"``) or every
segment (``"tr_fused"``), and ``resume=True`` continues from it (the
JAX package's ``.npz`` keys: either package reads the other's).  With
``tr_fused``, ``log_every=j`` (5 by default when ``checkpoint``,
``resume`` or ``save_iterations`` is set) runs the loop in j-iteration
segments whose log carries real segment-end times.  ``data_parallel=True``
shards the image batch over a mesh (:func:`data_parallel_mesh`: every
visible card for ``device="cuda"``, one shard on any other device):
``method="tr"`` runs the sharded learning functions of
:mod:`..parallel.sharded` (``inner_tol`` raises, as in the JAX package),
``"tr_fused"`` the fused learner with ``mesh=``, ``"single_loop"`` every
family's single-loop learner with ``mesh=``.  Any ``backend`` but
``"auto"`` raises ``NotImplementedError`` (:func:`check_backend`:
``device=`` chooses what runs).  ``visualise=True`` shows the iterates of ``method="tr"`` in a
:class:`..bilevel.harness.LiveView`; the other methods ignore it, as in
the JAX package.

Beyond the JAX surface, ``check_every`` (the inner solve's early-stop
cadence) and ``hypergrad_cfg`` (a :class:`HypergradConfig`) are parameters,
so a caller can run the flagship's settings through this entry point.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from ..bilevel.first_order import single_loop_learn
from ..bilevel.fused import bilevel_learn_fused
from ..bilevel.harness import BilevelResult, BilevelState, LiveView, _host
from ..bilevel.trust_region import bilevel_learn
from ..data import (full_datasetname, testdataset, write_png_color,
                    write_png_gray)
from ..learning import (make_sumregs_learning_function,
                        make_tv_learning_function)
from ..metrics import l2_cost, psnr_np, ssim_np
from ..models import sumregs_model, tv_model
from ..ops import PatchOp
from ..parallel import (make_batch_mesh,
                        make_sharded_sumregs_learning_function,
                        make_sharded_tv_learning_function)
from ..solvers import denoise_pdps
from ..solvers.hypergrad import HypergradConfig
from ..utils.checkpoint import (CheckpointWriter, load_checkpoint,
                                save_checkpoint)
from ..utils.config import Params, check_backend, merge
from ..viz import plot_cost_contour, plot_cost_curve, write_log
from ..viz.log import BilevelLogEntry

__all__ = ["TVDenoise", "L2CostFunction",
           "generate_scalar_tv_cost", "generate_cost_plot",
           "generate_2d_tv_cost", "generate_2d_cost_plot",
           "scalar_bilevel_tv_learn", "patch_bilevel_tv_learn",
           "scalar_bilevel_sumregs_learn", "patch_bilevel_sumregs_learn",
           "validate_tv_parameter", "validate_sumregs_parameter",
           "save_results", "linear_stretch",
           "default_params", "bilevel_params", "patch_bilevel_params",
           "sumregs_bilevel_params", "patch_sumregs_bilevel_params",
           "check_backend", "single_loop_log_every", "single_loop_state",
           "run_single_loop", "run_bilevel", "data_parallel_mesh"]

default_save_prefix = "output"

default_params = Params(
    verbose_iter=1,
    maxiter=20,
    save_results=True,
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

_TV = tv_model()
_SUMREGS = sumregs_model()


def reject_unported(params) -> None:
    """Raise for a ``backend`` the port does not take."""
    check_backend(params.get("backend", "auto"))


def data_parallel_mesh(device):
    """The mesh of ``data_parallel=True``: every visible card (the JAX
    package's ``make_batch_mesh()``: all local devices) for a CUDA
    ``device``; one shard on ``device`` otherwise (the CPU's plain
    versions)."""
    device = torch.device(device)
    if device.type == "cuda":
        return make_batch_mesh()
    return make_batch_mesh(devices=[device])


def refuse_inner_tol(params) -> None:
    """The sharded learning functions run the fixed budget: ``inner_tol``
    with ``data_parallel=True`` raises, as in the JAX package."""
    if params.get("inner_tol") is not None:
        raise ValueError(
            "inner_tol is not supported with data_parallel=True "
            "(the sharded learning functions run the fixed budget)")


def _canon(params):
    """Resolve a partial dataset name once, so the save paths, prefixes
    and the loader agree."""
    return params | dict(dataset_name=full_datasetname(params.dataset_name))


def _torch_dtype(params):
    return getattr(torch, str(params.get("dtype", "float64")))


def _load(params, device):
    """Dataset → (O, M, N) tensors on ``device`` in the params dtype;
    ``color=True`` in params loads planar (O, 3, M, N) stacks."""
    true_, data = testdataset(params.dataset_name,
                              color=bool(params.get("color")))
    n = int(params.num_samples)
    dt = _torch_dtype(params)
    return (torch.as_tensor(true_[:n], dtype=dt).to(device),
            torch.as_tensor(data[:n], dtype=dt).to(device))


def _out_dir(params) -> str:
    path = os.path.join(default_save_prefix, params.dataset_name)
    os.makedirs(path, exist_ok=True)
    return path


def linear_stretch(x) -> np.ndarray:
    """Min-max stretch of the whole stack to [0, 1], float64 on the
    host."""
    x = np.asarray(_host(x), dtype=np.float64)
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


# ---------------------------------------------------------------------------
# Standalone denoising and cost sweeps
# ---------------------------------------------------------------------------

def TVDenoise(data, parameter, visualize: bool = False, maxiter: int = 10000,
              device="cuda"):
    """TV denoising of an (O, M, N) stack on ``device`` with a scalar α or
    an (m, n) patch grid (upsampled to an (M, N) map): kernel A, cold, a
    fixed budget.  ``visualize`` shows the first result in a
    :class:`LiveView` (nothing on a headless backend)."""
    data = torch.as_tensor(data).to(device)
    p = np.asarray(parameter)
    if p.ndim == 2:  # patch parameter → an (M, N) map
        pop = PatchOp.for_image(p, data)
        alpha = pop.apply(torch.as_tensor(p, dtype=data.dtype,
                                          device=data.device))
    else:
        alpha = torch.as_tensor(p, dtype=data.dtype)
    u = denoise_pdps(data, (alpha,), _TV, maxiter=maxiter)
    if visualize:
        LiveView().show(_host(u[0] if u.ndim == 3 else u), None)
    return u


def L2CostFunction(u, true_) -> float:
    """½‖u − ū‖² over the whole stack (``true_`` is moved to ``u``'s
    device; the difference is taken in the wider dtype)."""
    u = torch.as_tensor(u)
    return float(l2_cost(u, torch.as_tensor(true_).to(u.device)))


def _sweep_params(dataset_name, num_samples, dtype, **extra):
    return _canon(merge(default_params, dataset_name=dataset_name,
                        num_samples=num_samples, dtype=dtype, **extra))


def generate_cost(dataset_name, parameter_range, *, num_samples=1,
                  maxiter=10000, dtype="float64", freq=10, device="cuda"):
    """The cost ½‖u(α) − ū‖² over scalar TV weights α: one cold
    ``maxiter``-iteration solve per α; every ``freq``-th cost goes to
    stderr.  Saved to ``output/<ds>/<ds>_cost.npz`` (``parameter_range``,
    ``costs``)."""
    params = _sweep_params(dataset_name, num_samples, dtype)
    true_, data = _load(params, device)
    costs = np.asarray(
        [L2CostFunction(denoise_pdps(data, (float(a),), _TV,
                                     maxiter=maxiter), true_)
         for a in np.asarray(parameter_range)], dtype=np.dtype(params.dtype))
    pr = np.asarray(parameter_range)
    for i in range(freq - 1, len(costs), freq):
        print(f"Denoising parameter {pr[i]}: cost = {costs[i]}",
              file=sys.stderr)
    out = _out_dir(params)
    np.savez(os.path.join(out, f"{params.dataset_name}_cost.npz"),
             parameter_range=np.asarray(parameter_range), costs=costs)
    return costs


def _plot_npz(dataset_name, npz_suffix, plot_suffix, plot, **kw):
    """Plot ``output/<ds>/<ds><npz_suffix>.npz`` to
    ``output/<ds>/<ds><plot_suffix>``.{png,pdf}; returns that base path."""
    dataset_name = full_datasetname(dataset_name)
    path = os.path.join(default_save_prefix, dataset_name,
                        f"{dataset_name}{npz_suffix}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"No cost calculation found at {path}")
    z = np.load(path)
    base = os.path.join(default_save_prefix, dataset_name,
                        f"{dataset_name}{plot_suffix}")
    if "parameter_range" in z:
        plot(z["parameter_range"], z["costs"], base, **kw)
    else:
        plot(z["parameter_range_1"], z["parameter_range_2"], z["costs"],
             base, **kw)
    return base


def generate_cost_plot(dataset_name):
    """Log-log plot of :func:`generate_cost`'s sweep."""
    return _plot_npz(dataset_name, "_cost", "_cost_plot", plot_cost_curve)


def generate_scalar_tv_cost(dataset_name, parameter_range, *, num_samples=1,
                            **kw):
    """:func:`generate_cost` (the JAX package's name for the TV sweep)."""
    return generate_cost(dataset_name, parameter_range,
                         num_samples=num_samples, **kw)


def generate_2d_cost(dataset_name, parameter_range_1, parameter_range_2, *,
                     num_samples=1, maxiter=10000, dtype="float64",
                     device="cuda"):
    """The cost over (α₁, α₂) TV weight maps, α₁ on the upper half of the
    image and α₂ on the lower (a (2, 1) patch grid): one cold solve per
    pair; saved to ``<ds>_cost_2d.npz`` (``parameter_range_1``,
    ``parameter_range_2``, ``costs`` of shape (len 1, len 2))."""
    params = _sweep_params(dataset_name, num_samples, dtype)
    true_, data = _load(params, device)
    r1 = np.asarray(parameter_range_1, dtype=np.float64)
    r2 = np.asarray(parameter_range_2, dtype=np.float64)
    A1, A2 = np.meshgrid(r1, r2, indexing="ij")
    pop = PatchOp((2, 1), tuple(data.shape[-2:]))
    costs = []
    for a1, a2 in zip(A1.ravel(), A2.ravel()):
        pair = torch.as_tensor([[a1], [a2]], dtype=data.dtype,
                               device=data.device)
        u = denoise_pdps(data, (pop.apply(pair),), _TV, maxiter=maxiter)
        costs.append(L2CostFunction(u, true_))
    costs = np.asarray(costs, dtype=np.dtype(params.dtype)).reshape(A1.shape)
    out = _out_dir(params)
    np.savez(os.path.join(out, f"{params.dataset_name}_cost_2d.npz"),
             parameter_range_1=r1, parameter_range_2=r2, costs=costs)
    return costs


def generate_2d_cost_plot(dataset_name):
    """Contour plot of :func:`generate_2d_cost`'s sweep."""
    return _plot_npz(dataset_name, "_cost_2d", "_cost_plot_2d",
                     plot_cost_contour)


def generate_2d_tv_cost(dataset_name, parameter_range_1, parameter_range_2,
                        *, num_samples=1, **kw):
    """:func:`generate_2d_cost` (the JAX package's name)."""
    return generate_2d_cost(dataset_name, parameter_range_1,
                            parameter_range_2, num_samples=num_samples, **kw)


# ---------------------------------------------------------------------------
# Result reporting
# ---------------------------------------------------------------------------

def _ssim_any(ref, img):
    """SSIM of a grayscale (M, N) or planar color (C, M, N) image (color:
    the mean over channels)."""
    ref = np.asarray(ref)
    if ref.ndim == 3:
        return float(np.mean([ssim_np(ref[c], np.asarray(img)[c])
                              for c in range(ref.shape[0])]))
    return ssim_np(ref, img)


def _write_image(path, img):
    """Grayscale or planar-color PNG by shape."""
    img = np.asarray(img)
    if img.ndim == 3:
        write_png_color(path, img)
    else:
        write_png_gray(path, img)


def _write_quality_table(path: str, b, b_data, opt_img):
    """Per-image SSIM/PSNR of the noisy and the reconstructed images
    against the true ones and a row of the means of the reconstructions',
    host float64; returns (mean SSIM, mean PSNR)."""
    b = np.asarray(b)
    b_data = np.asarray(b_data)
    opt_img = np.asarray(opt_img)
    O = b.shape[0]
    with open(path, "w") as io:
        io.write("img_num \t orig_ssim \t orig_psnr \t out_ssim \t out_psnr\n")
        mean_ssim = mean_psnr = 0.0
        for i in range(O):
            noisy_ssim = _ssim_any(b[i], b_data[i])
            noisy_psnr = psnr_np(b[i], b_data[i])
            out_ssim = _ssim_any(b[i], opt_img[i])
            out_psnr = psnr_np(b[i], opt_img[i])
            io.write(f"{i + 1}\t {noisy_ssim} \t {noisy_psnr} \t "
                     f"{out_ssim} \t {out_psnr}\n")
            mean_ssim += out_ssim
            mean_psnr += out_psnr
        io.write(f"\t\t\t\t\t {mean_ssim / O}\t {mean_psnr / O}\n")
    return mean_ssim / O, mean_psnr / O


def _save_image_triplets(out_path, prefix, b, b_data, opt_img):
    for i in range(np.asarray(b).shape[0]):
        _write_image(os.path.join(out_path, f"{prefix}_true_{i + 1}.png"),
                     np.asarray(b)[i])
        _write_image(os.path.join(out_path, f"{prefix}_data_{i + 1}.png"),
                     np.asarray(b_data)[i])
        _write_image(os.path.join(out_path, f"{prefix}_reco_{i + 1}.png"),
                     np.asarray(opt_img)[i])


def save_results(params, b, b_data, x, opt_img, st):
    """Write the log, the quality table, the PNG triplets and, for (m, n)
    and (m, n, K) parameters, the stretched parameter maps under
    ``output/<dataset>/<params.save_prefix>``; nothing unless
    ``params.save_results``.  ``b``, ``b_data`` and ``opt_img`` are host
    arrays."""
    if not params.save_results:
        return
    out_path = _out_dir(params)
    prefix = params.save_prefix
    perffile = os.path.join(out_path, prefix + ".txt")
    qualityfile = os.path.join(out_path, prefix + "_quality.txt")
    print("Saving " + perffile, file=sys.stderr)
    write_log(perffile, st.log, f"# params = {dict(params)!r}, x = {x!r}")
    _write_quality_table(qualityfile, b, b_data, opt_img)
    _save_image_triplets(out_path, prefix, b, b_data, opt_img)

    x = np.asarray(x)
    if x.ndim == 2:  # patch α: the upsampled map, stretched
        pop = PatchOp.for_image(x, np.asarray(b)[0])
        write_png_gray(os.path.join(out_path, prefix + "_par.png"),
                       linear_stretch(pop.apply(torch.as_tensor(x))))
    elif x.ndim == 3:  # (m, n, K) α: K maps stretched together
        pop = PatchOp.for_image(x[..., 0], np.asarray(b)[0])
        maps = np.stack([_host(pop.apply(torch.as_tensor(x[..., k])))
                         for k in range(x.shape[-1])], axis=-1)
        stretched = linear_stretch(maps)
        for k in range(x.shape[-1]):
            write_png_gray(
                os.path.join(out_path, f"{prefix}_par_{k + 1}.png"),
                stretched[..., k])


def _stretched_inputs(ds, stretch_all):
    """The true and noisy stacks as host arrays for :func:`save_results`:
    stretched (scalar TV, TGV², TV-L1) or as they are (patch TV, the sums
    of regularizers, VTV), as the JAX package writes them."""
    if stretch_all:
        return tuple(linear_stretch(d) for d in ds)
    return tuple(_host(d) for d in ds)


def report(params, ds, res: BilevelResult, stretch_all: bool
           ) -> BilevelResult:
    """:func:`save_results` of a learn on ``ds`` (its reconstruction
    stretched) and the result as it is."""
    b, b_noisy = _stretched_inputs(ds, stretch_all)
    save_results(params, b, b_noisy, res.x, linear_stretch(res.u),
                 res.state)
    return res


# ---------------------------------------------------------------------------
# Bilevel learning experiments
# ---------------------------------------------------------------------------

def _fused_to_result(res, *, it_offset: int = 0,
                     init_entries=()) -> BilevelResult:
    """FusedResult (log matrix) → host BilevelResult whose ``state.log``
    holds the resumed ``init_entries`` and then one BilevelLogEntry per
    outer iteration, numbered from ``it_offset + 1``, as the JAX package's
    ``_fused_to_result`` builds it: ``time`` the segment-end wall time of
    a segmented run, 0.0 in a single run (which times only the whole)."""
    st = BilevelState()
    st.log.extend(init_entries)
    k = int(res.iterations)
    times = res.times if res.times is not None else np.zeros(k)
    for i, row in enumerate(res.log[:k].tolist()):
        st.log.append(BilevelLogEntry(
            i + 1 + it_offset, float(times[i]), *row[:4],
            adjoint_cg_iters=row[4], adjoint_cg_converged=row[5]))
    return BilevelResult(x=res.x.numpy(), u=res.u.cpu().numpy(),
                         state=st, cost=float(res.cost),
                         g_norm=float(res.g_norm), iterations=k + it_offset)


def _ckpt_path(params) -> str:
    return os.path.join(_out_dir(params), params.save_prefix + "_ckpt.npz")


def _log_entries(rows):
    """Checkpoint log rows → BilevelLogEntry items (none for no rows)."""
    if rows is None or not np.asarray(rows).size:
        return []
    return [BilevelLogEntry(int(r[0]), *map(float, r[1:]))
            for r in np.asarray(rows)]


def _resumed(params, ckpt_path):
    """With ``resume`` set and a checkpoint at ``ckpt_path``: → (params
    with ``alpha0`` and ``delta0`` from it, its dense BFGS matrix or None,
    its log entries, its iteration); otherwise (params, None, [], 0)."""
    state = load_checkpoint(ckpt_path) if params.get("resume") else None
    if state is None:
        return params, None, [], 0
    params = params | dict(alpha0=state["x"], delta0=float(state["delta"]))
    B = state.get("B")
    init_B = B if B is not None and np.asarray(B).ndim == 2 else None
    it = int(state["iteration"])
    print(f"resuming from {ckpt_path} (iteration {it})", file=sys.stderr)
    return params, init_B, _log_entries(state.get("log")), it


def _save_iteration_fn(params):
    """``fn(it, img)`` writing ``<prefix>_iter_<it>.png`` (the image
    clipped to [0, 1]) when ``save_iterations`` is set, else None."""
    if not params.get("save_iterations"):
        return None
    out = _out_dir(params)

    def save_iter_fn(it, img):
        _write_image(os.path.join(out, f"{params.save_prefix}_iter_{it}.png"),
                     np.clip(img, 0, 1))
    return save_iter_fn


def _fused_observability(params):
    """Resume, checkpoint and per-iterate snapshot hooks of the fused
    trust region, shared by every family (the JAX package's
    ``_fused_observability``).  The hooks run as the segment callback of
    segmented dispatch (``log_every``; 5 when ``checkpoint``, ``resume``
    or ``save_iterations`` is set and ``log_every`` is not).  Returns
    ``(params, log_every, seg_cb, init_B, it_offset, init_entries)``;
    ``params`` gains the resumed ``alpha0``/``delta0`` and the remaining
    ``maxiter``.  The carry is ``(it, x_flat, Bst, delta, fx, gx, u,
    state, log)`` (:mod:`..bilevel.tr_core`)."""
    log_every = params.get("log_every")
    if log_every is None and any(params.get(k) for k in
                                 ("checkpoint", "resume", "save_iterations")):
        log_every = 5
    ckpt_path = _ckpt_path(params)
    params, init_B, init_entries, it_offset = _resumed(params, ckpt_path)
    if it_offset:
        params = params | dict(maxiter=max(0, int(params.maxiter) - it_offset))
    checkpoint = bool(params.get("checkpoint") or params.get("resume"))
    save_iter_fn = _save_iteration_fn(params)
    param_shape = tuple(np.shape(params.alpha0))
    seg_cb = None
    if log_every is not None and (checkpoint or save_iter_fn):
        def seg_cb(it, carry, elapsed):
            it_abs = it + it_offset
            if checkpoint:
                x, bst, delta, log = carry[1], carry[2], carry[3], carry[8]
                rows = [[e.iter, e.time, e.function_value, e.g_norm,
                         e.delta, e.step_norm] for e in init_entries]
                rows += [[i + 1 + it_offset, elapsed, *log[i, :4].tolist()]
                         for i in range(it)]
                # the dense BFGS matrix is saved; an L-BFGS state is not,
                # as in the host loop
                B = bst.numpy() if isinstance(bst, torch.Tensor) else None
                save_checkpoint(ckpt_path,
                                x=x.numpy().reshape(param_shape),
                                delta=float(delta), B=B, log_rows=rows,
                                iteration=it_abs)
            if save_iter_fn is not None:
                save_iter_fn(it_abs, _host(carry[6][0]))

    return params, log_every, seg_cb, init_B, it_offset, init_entries


def run_bilevel(params, learning_function, device, ds=None,
                visualise: bool = False, stretch_all: bool = False
                ) -> BilevelResult:
    """The host trust region behind the experiment surface (the JAX
    package's ``_run_bilevel``): ``learning_function`` on ``ds`` (by
    default the params' dataset on ``device``), resumed from
    ``<prefix>_ckpt.npz`` with ``resume`` (its iterate, radius, BFGS
    matrix and log; the numbering and the budget continue), checkpointed
    after every accepted iteration with ``checkpoint`` or ``resume``,
    ``save_iterations`` PNGs of each logged iterate's first image, the
    reconstruction read to the host once at the end, then
    :func:`save_results`."""
    reject_unported(params)
    if ds is None:
        ds = _load(params, device)
    ckpt_path = _ckpt_path(params)
    params, init_B, init_log, _ = _resumed(params, ckpt_path)
    checkpoint = (CheckpointWriter(ckpt_path) if params.get("checkpoint")
                  or params.get("resume") else None)
    res = bilevel_learn(ds, learning_function, xinit=params.alpha0,
                        params=params, visualise=visualise,
                        save_iteration_fn=_save_iteration_fn(params),
                        checkpoint=checkpoint, init_B=init_B,
                        init_log=init_log or None)
    res = dataclasses.replace(res, u=res.u.cpu().numpy())
    return report(params, ds, res, stretch_all)


def _make_lf(params, factory, device):
    """The learning function of ``method="tr"`` (the JAX package's
    ``_make_lf``): the inner solve's budget, its early stop ``inner_tol``
    (which also chains the PDPS state across evaluations) at
    ``check_every``, and ``hypergrad_cfg``; with ``data_parallel`` the
    sharded function of the same family on :func:`data_parallel_mesh`."""
    if params.get("data_parallel"):
        refuse_inner_tol(params)
        sharded = (make_sharded_tv_learning_function
                   if factory is make_tv_learning_function
                   else make_sharded_sumregs_learning_function)
        return sharded(data_parallel_mesh(device),
                       maxiter=int(params.inner_maxiter),
                       cfg=params.hypergrad_cfg)
    solver_kwargs = dict(check_every=int(params.check_every))
    if params.get("inner_tol") is not None:
        solver_kwargs["tol"] = float(params.inner_tol)
    return factory(maxiter=int(params.inner_maxiter),
                   cfg=params.hypergrad_cfg, solver_kwargs=solver_kwargs,
                   device=device)


def run_fused(params, device, learn, stretch_all: bool = False,
              **kw) -> BilevelResult:
    """A fused trust region behind the experiment surface (the JAX
    package's ``_run_fused``): ``learn(ds, xinit=, params=,
    inner_maxiter=, inner_tol=, check_every=, device=, mesh=, log_every=,
    segment_callback=, init_B=, **kw)`` on the params' dataset with the
    hooks of :func:`_fused_observability` (``mesh`` by
    :func:`data_parallel_mesh` when ``data_parallel`` is set), then
    :func:`save_results`."""
    reject_unported(params)
    mesh = (data_parallel_mesh(device) if params.get("data_parallel")
            else None)
    ds = _load(params, device)
    (params, log_every, seg_cb, init_B, it_offset,
     init_entries) = _fused_observability(params)
    res = learn(ds, xinit=np.asarray(params.alpha0), params=params,
                inner_maxiter=int(params.inner_maxiter),
                inner_tol=params.get("inner_tol"),
                check_every=int(params.check_every), device=device,
                mesh=mesh,
                log_every=None if log_every is None else int(log_every),
                segment_callback=seg_cb, init_B=init_B, **kw)
    out = _fused_to_result(res, it_offset=it_offset,
                           init_entries=init_entries)
    return report(params, ds, out, stretch_all)


def _run_fused(params, model_kind, device, stretch_all):
    """The fused trust region on ``tv_model()`` or ``sumregs_model()``, with
    the family's switch radius to the regularized gradient (TV Δt = 1e-6,
    sum of regularizers 1e-3, as in the JAX package)."""
    tv = model_kind == "tv"
    return run_fused(params, device, bilevel_learn_fused, stretch_all,
                     model=_TV if tv else _SUMREGS,
                     delta_t=1e-6 if tv else 1e-3, cfg=params.hypergrad_cfg)


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


def run_single_loop(params, device, learn, stretch_all: bool = False,
                    **extra) -> BilevelResult:
    """A single-loop first-order learner behind the experiment surface
    (the JAX package's ``_run_single_loop`` and its families'
    ``_run_*_single_loop``): ``learn(utrue, f, x0, **kw)`` is one of the
    ``single_loop_*_learn`` functions, run in ``single_loop_log_every(
    outer)`` segments (``log_every`` in params is not read, as in the JAX
    package) with the ``sl_*`` knobs and ``extra``, then
    :func:`save_results`.  ``data_parallel=True`` hands the learner
    :func:`data_parallel_mesh`'s mesh."""
    _reject_flags(params, "single_loop",
                  ("checkpoint", "resume", "save_iterations", "inner_tol"))
    reject_unported(params)
    if params.get("data_parallel"):
        extra["mesh"] = data_parallel_mesh(device)
    ds = _load(params, device)
    outer = int(params.sl_outer)
    res = learn(ds[0], ds[1], np.asarray(params.alpha0), outer=outer,
                n_inner=int(params.sl_inner), n_adj=int(params.sl_adj),
                lr=float(params.sl_lr),
                log_every=single_loop_log_every(outer), **extra)
    st, g_norm = single_loop_state(res, params.alpha0)
    out = BilevelResult(x=res.alpha.cpu().numpy(), u=res.u.cpu().numpy(),
                        state=st, cost=float(res.cost), g_norm=g_norm,
                        iterations=outer)
    return report(params, ds, out, stretch_all)


def _run_single_loop(params, model_kind, device, stretch_all):
    model = _TV if model_kind == "tv" else _SUMREGS
    return run_single_loop(
        params, device,
        lambda ut, f, x0, **kw: single_loop_learn(ut, f, x0, model, **kw),
        stretch_all)


def experiment_params(family_params, kwargs, prefix, parameter=None):
    """An entry point's params: the defaults, the family's set and the
    caller's keywords, the dataset name resolved, and ``save_prefix`` =
    ``prefix`` (its ``{shape}`` the shape of ``parameter``, by default of
    ``alpha0``) + the dataset name."""
    params = _canon(merge(default_params, family_params, kwargs))
    shape = np.shape(params.alpha0 if parameter is None else parameter)
    return params | dict(save_prefix=prefix.format(shape=tuple(shape))
                         + params.dataset_name)


def _run_method(params, model_kind, device, visualise, stretch_all):
    """``method="tr"`` (the host trust region), ``"tr_fused"`` or
    ``"single_loop"``."""
    method = params.get("method")
    if method == "single_loop":
        return _run_single_loop(params, model_kind, device, stretch_all)
    if method == "tr_fused":
        return _run_fused(params, model_kind, device, stretch_all)
    if method == "tr":
        factory = (make_tv_learning_function if model_kind == "tv"
                   else make_sumregs_learning_function)
        return run_bilevel(params, _make_lf(params, factory, device), device,
                           visualise=visualise, stretch_all=stretch_all)
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
    params = experiment_params(bilevel_params, kwargs,
                               "tv_optimal_parameter_scalar_")
    return _run_method(params, "tv", device, visualise, stretch_all=True)


def patch_bilevel_tv_learn(visualise: bool = False, device="cuda",
                           **kwargs) -> BilevelResult:
    """Learn an (m, n) patch grid of TV weights (default 2×2 from 1e-4)
    with either trust region or the single-loop learner."""
    params = experiment_params(patch_bilevel_params, kwargs,
                               "tv_optimal_parameter_{shape}_")
    return _run_method(params, "tv", device, visualise, stretch_all=False)


def scalar_bilevel_sumregs_learn(visualise: bool = False, device="cuda",
                                 **kwargs) -> BilevelResult:
    """Learn the (3,) weights of the forward, backward and centred TV terms
    (default 1e-3 each) with either trust region or the single-loop
    learner."""
    params = experiment_params(sumregs_bilevel_params, kwargs,
                               "sumregs_optimal_parameter_scalar_")
    return _run_method(params, "sumregs", device, visualise,
                       stretch_all=False)


def patch_bilevel_sumregs_learn(image_pair=None, dataset_name=None,
                                visualise: bool = False, device="cuda",
                                **kwargs) -> BilevelResult:
    """Learn an (m, n, 3) patch stack of sum-of-regularizers weights
    (default 2×2×3 from 1e-3, β₂ = 1.5) with either trust region or the
    single-loop learner, on ``dataset_name``; or, given
    ``image_pair=(true_image, noisy_image)``, on that one (M, N) pair (a
    1 × M × N stack in the params dtype) with the host trust region, which
    that form runs whatever ``method`` says, as in the JAX package (its
    saved images: the pair and the reconstruction, each stretched)."""
    if dataset_name is not None:
        kwargs = dict(kwargs, dataset_name=dataset_name)
    # the JAX prefix has no "_" between the shape and the dataset name
    params = experiment_params(patch_sumregs_bilevel_params, kwargs,
                               "sumregs_optimal_parameter_patch_{shape}")
    if image_pair is None:
        return _run_method(params, "sumregs", device, visualise,
                           stretch_all=False)
    dt = _torch_dtype(params)
    ds = tuple(torch.as_tensor(np.asarray(im), dtype=dt)[None].to(device)
               for im in image_pair[:2])
    lf = _make_lf(params, make_sumregs_learning_function, device)
    return run_bilevel(params, lf, device, ds=ds, visualise=visualise,
                       stretch_all=True)


# ---------------------------------------------------------------------------
# Validation (denoise at a fixed learned parameter)
# ---------------------------------------------------------------------------

def _validate(params, u, img, noisy):
    """The quality table and the PNG triplets of a validation; returns
    (mean SSIM, mean PSNR)."""
    out_path = _out_dir(params)
    qualityfile = os.path.join(out_path,
                               params.save_prefix + "_quality.txt")
    mean_ssim, mean_psnr = _write_quality_table(qualityfile, img, noisy, u)
    _save_image_triplets(out_path, params.save_prefix, img, noisy, u)
    return mean_ssim, mean_psnr


def finish_validation(params, parameter, u, img, noisy):
    """The cost of the host reconstruction ``u``, printed, then
    :func:`_validate`: → the validation's dict."""
    cost = L2CostFunction(u, img)
    print(f"Denoising parameter {parameter}: cost = {cost}",
          file=sys.stderr)
    mean_ssim, mean_psnr = _validate(params, u, img, noisy)
    return dict(cost=cost, mean_ssim=mean_ssim, mean_psnr=mean_psnr, u=u)


def validate_tv_parameter(parameter, device="cuda", **kwargs):
    """One :func:`TVDenoise` of the whole dataset (the ``num_samples`` cut
    does not apply) at a learned scalar α or (m, n) grid, 10,000
    iterations, on ``device``; the quality table and the PNG triplets
    under ``output/<dataset>/val_tv_…``.  Returns ``dict(cost, mean_ssim,
    mean_psnr, u)`` (``u`` a host array)."""
    params = experiment_params(bilevel_params, kwargs,
                               "val_tv_optimal_parameter_scalar_{shape}_",
                               parameter)
    img, noisy = testdataset(params.dataset_name)
    u = _host(TVDenoise(torch.as_tensor(noisy, dtype=_torch_dtype(params)),
                        parameter, device=device))
    return finish_validation(params, parameter, u, img, noisy)


def validate_sumregs_parameter(parameter, device="cuda", **kwargs):
    """The sum of regularizers denoised at learned (3,) or (m, n, 3)
    weights (the grids upsampled), 5000 iterations, on ``device``; as
    :func:`validate_tv_parameter` otherwise."""
    params = experiment_params(
        bilevel_params, kwargs,
        "val_sumregs_optimal_parameter_scalar_{shape}_", parameter)
    img, noisy = testdataset(params.dataset_name)
    f = torch.as_tensor(noisy, dtype=_torch_dtype(params)).to(device)
    param = np.asarray(parameter)
    if param.ndim == 3:
        pop = PatchOp.for_image(param[..., 0], noisy[0])
        alphas = tuple(pop.apply(torch.as_tensor(param[..., k], dtype=f.dtype,
                                                 device=f.device))
                       for k in range(param.shape[-1]))
    else:
        alphas = param
    u = _host(denoise_pdps(f, alphas, _SUMREGS, maxiter=5000))
    return finish_validation(params, parameter, u, img, noisy)
