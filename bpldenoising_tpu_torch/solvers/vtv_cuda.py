"""The vectorial-TV (color) Chambolle–Pock solve as a CUDA kernel
(``csrc/vtv.cu``), replacing the TPU kernel
``bpldenoising_tpu/solvers/vtv_pallas.py::_make_vtv_kernel``.

:func:`vtv_denoise_pdps_cuda` takes the arguments of the plain
:func:`.pdps._denoise_pdps_impl` on :func:`..models.vtv_model` and returns
what it returns.  For tensors on the CPU it runs that plain version; for
CUDA tensors it launches the kernel (a build or launch failure raises, as
do inputs the kernel does not take); any other device raises.  ``f`` is
an (O, C, M, N) or (C, M, N) stack; α is a scalar or one (M, N) map.
``state0`` is the jnp path's ``(u, (y,))`` (y of shape (..., C, 2, M, N))
or the Pallas kernel's ``(u, px, py)`` (each (..., C, M, N)); the returned
state is always ``(u, (y,))``.  The early stop is the plain version's:
every ``check_every`` iterations, stop once the max over the channel
planes of ‖Δu‖/‖u‖ is ≤ ``tol``.  :data:`last_iters` holds the iteration
count of the latest solve.

The kernel runs one launch per early-stop chunk (all ``maxiter``
iterations without ``tol``), one thread-block cluster an image on the
bands of ``csrc/vtv_cluster.cuh``, when :func:`.cluster_plan.vtv_plan`
(the rule the single-loop VTV learner also takes) finds that the image's
bands fit in shared memory; otherwise (1×3×256², say) its two-launch
form, two launches an iteration on state in global memory.  The rule is
decided from the shapes before any launch; a cluster launch that the card
refuses raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..models import vtv_model
from .cluster_plan import vtv_plan
from .pdps import _denoise_pdps_impl, step_sizes
from .pdps_cuda import check_cuda_input, check_plane

__all__ = ["vtv_denoise_pdps_cuda", "as_jnp_state", "launches",
           "cluster_calls", "device_ops", "last_iters"]

#: calls that launched the CUDA kernel (one per solve, either form)
launches = 0
#: those of them that ran the cluster form (one launch per chunk)
cluster_calls = 0
#: device operations those calls issued (launches and copies, as the C side
#: counts them: in the cluster form the table copy, then 1 launch without
#: tol or per early-stop chunk 3, the launch, pd_change and the read of
#: the ratios, and a last copy when u ends in the second buffer; in the
#: two-launch form 2 an iteration and per chunk 3, the copy of u, pd_change
#: and the read)
device_ops = 0
#: iterations run by the latest solve through this module
last_iters = 0

_VTV = vtv_model()


def as_jnp_state(state0, dtype=None):
    """A warm VTV state in either JAX format, the jnp path's ``(u, ys)``
    (ys a 1-tuple of (..., C, 2, M, N) duals, or that dual itself) or the
    Pallas kernel's ``(u, px, py)``, as ``(u, (y,))``."""
    if state0 is None:
        return None
    if len(state0) == 3:
        u0, px, py = (torch.as_tensor(s, dtype=dtype) for s in state0)
        return u0, (torch.stack([px, py], dim=-3),)
    if len(state0) == 2:
        u0, ys = state0
        y = ys[0] if isinstance(ys, (tuple, list)) else ys
        return (torch.as_tensor(u0, dtype=dtype),
                (torch.as_tensor(y, dtype=dtype),))
    raise ValueError("a VTV state is (u, ys) or (u, px, py), got "
                     f"{len(state0)} arrays")


def _launch(f, a, state0, *, tau, sigma, gamma, accel, maxiter, tol,
            check_every):
    """One kernel solve from ``state0`` ((u, (y,)) or None).  Returns
    ``(u, y, iters)``."""
    check_cuda_input(f)
    if f.ndim < 3:
        raise ValueError(f"expected (..., C, M, N) color stacks, got "
                         f"{tuple(f.shape)}")
    dtype, dev = f.dtype, f.device
    f = f.contiguous()
    C, M, N = (int(d) for d in f.shape[-3:])
    O = f.numel() // (C * M * N)
    if a.ndim != 0 and tuple(a.shape) != (M, N):
        raise NotImplementedError(
            f"the VTV kernel takes a scalar α or one (M, N) = {(M, N)} "
            f"map, got {tuple(a.shape)}")
    y_shape = f.shape[:-2] + (2,) + f.shape[-2:]
    if state0 is None:
        u = f.clone()
        y = torch.zeros(y_shape, dtype=dtype, device=dev)
    else:
        u0, (y0,) = state0
        check_plane(u0, f.shape, f, "state0 u")
        check_plane(y0, y_shape, f, "state0 y")
        u, y = u0.contiguous().clone(), y0.contiguous().clone()
    amap = a.to(dev).contiguous() if a.ndim else None
    plan = vtv_plan(M, N, C, f.element_size())
    # the two-launch form's ū planes, or the cluster form's (τ, ω, σ)
    # table; u's second buffer for the early stop
    ubar = None if plan.resident else torch.empty_like(f)
    tab = torch.empty((max(int(maxiter), 1), 3), dtype=dtype, device=dev) \
        if plan.resident else None
    uprev = torch.empty_like(f) if tol is not None else None
    ratio = torch.empty((max(O * C, 1),), dtype=dtype, device=dev)
    lib = _build.library()
    fn = lib.bpl_vtv_solve_f32 if dtype == torch.float32 \
        else lib.bpl_vtv_solve_f64
    iters, ops = ctypes.c_int(0), ctypes.c_int(0)
    global launches, cluster_calls, device_ops
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with _build.COUNTS:
            launches += 1
            cluster_calls += int(plan.resident)
        err = fn(f.data_ptr(), u.data_ptr(), y.data_ptr(),
                 *(None if t is None else t.data_ptr()
                   for t in (ubar, uprev)), ratio.data_ptr(),
                 None if tab is None else tab.data_ptr(),
                 None if amap is None else amap.data_ptr(),
                 0.0 if amap is not None else float(a), O, C, M, N,
                 plan.cluster, plan.rows, int(plan.resident), float(tau),
                 float(sigma), float(gamma), int(bool(accel)), int(maxiter),
                 int(tol is not None), 0.0 if tol is None else float(tol),
                 int(check_every), ctypes.byref(iters), ctypes.byref(ops),
                 stream)
    with _build.COUNTS:
        device_ops += ops.value
    _build.check(err, f"vtv kernel ({plan})")
    return u, y, int(iters.value)


def vtv_denoise_pdps_cuda(f, alphas, state0=None, *, tau0=5.0,
                          sigma0=0.99 / 5.0, gamma=1.0, maxiter: int = 5000,
                          accel: bool = True, tol=None,
                          check_every: int = 500, return_dual: bool = False):
    """The VTV kernel (CUDA tensors) or its plain version (CPU tensors).
    ``alphas`` is the model's 1-tuple ``(α,)``.  Returns ``u`` or, with
    ``return_dual``, ``(u, (y,), iters)``."""
    global last_iters
    f = torch.as_tensor(f)
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"expected a CPU or CUDA tensor, got {f.device}")
    if len(alphas) != 1:
        raise ValueError(f"the VTV model takes one weight, got {len(alphas)}")
    a = torch.as_tensor(alphas[0], dtype=f.dtype)
    state0 = as_jnp_state(state0, f.dtype)
    kw = dict(maxiter=int(maxiter), tol=None if tol is None else float(tol),
              check_every=int(check_every))
    if f.device.type == "cpu":
        u, (y,), iters = _denoise_pdps_impl(
            f, (a,), state0, model=_VTV, tau0=tau0, sigma0=sigma0,
            gamma=gamma, accel=bool(accel), return_dual=True, **kw)
    else:
        tau, sigma = step_sizes(_VTV, tau0, sigma0, f.dtype, f.device)
        u, y, iters = _launch(f, a, state0, tau=tau, sigma=sigma,
                              gamma=gamma, accel=accel, **kw)
    last_iters = iters
    if return_dual:
        return u, (y,), iters
    return u
