"""The TV-L1 Chambolle–Pock solves as one CUDA kernel (``csrc/tvl1.cu``),
in two forms: the plain TV-L1 iteration, replacing
``bpldenoising_tpu/solvers/tvl1_pallas.py::_make_tvl1_kernel``, and the
Huber-smoothed one, replacing
``bpldenoising_tpu/solvers/tvl1_huber_pallas.py::_make_huber_kernel``.

:func:`tvl1_denoise_cuda` and :func:`tvl1_huber_denoise_cuda` take the
arguments of the plain :func:`.tvl1.tvl1_denoise` and
:func:`.tvl1_huber.tvl1_huber_denoise` and return what they return.  For
tensors on the CPU they run the plain versions; for CUDA tensors they
launch the kernel (a build or launch failure raises); any other device
raises.  ``state0`` is ``(u, y)`` or the Pallas kernels' ``(u, px, py)``;
the returned state is always ``(u, y)``.  :data:`last_iters` holds the
iteration count of the latest solve (the Huber form returns none, as in
the JAX package).

The kernel runs one launch per early-stop chunk (all ``maxiter``
iterations without ``tol``), one thread-block cluster an image on the
bands of ``csrc/pd_cluster.cuh``, when :func:`tvl1_plan` finds that the
image's bands fit in shared memory; otherwise (1×512² float32, say) its
two-launch form, two launches an iteration on state in global memory.
The rule is decided from the shapes before any launch; a cluster launch
that the card refuses raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .cluster_plan import MAX_CLUSTER, MAX_CLUSTER_NP, SMS, pd_plan
from .pdps_cuda import check_cuda_input, check_plane
from .tvl1 import _tvl1_loop, as_jnp_state, cold_state, step_sizes
from .tvl1_huber import _tvl1_huber_loop, huber_prox_consts

__all__ = ["tvl1_denoise_cuda", "tvl1_huber_denoise_cuda", "tvl1_plan",
           "launches", "cluster_calls", "device_ops", "last_iters"]

#: calls that launched the CUDA kernel (one per solve, either form)
launches = 0
#: those of them that ran the cluster form (one launch per chunk)
cluster_calls = 0
#: device operations those calls issued (launches and copies, as the C loop
#: counts them: per early-stop chunk 4 in the cluster form, the launch, the
#: two passes of the sums and the read; 2 per iteration and 4 per chunk in
#: the two-launch form, whose chunk starts with a copy; in either form a
#: last copy when u ends in the second buffer)
device_ops = 0
#: iterations run by the latest solve through this module
last_iters = 0
_THREADS = 256   # BPL_THREADS in csrc/common.cuh


def tvl1_plan(O: int, M: int, N: int, itemsize: int):
    """The band plan of an (O, M, N) solve: :func:`.cluster_plan.pd_plan`
    with one forward-difference dual block, up to 16 CTAs an image while
    the batch's clusters of 16 have an SM a CTA (O·16 ≤ 132: an image
    spreads over more SMs; on an H100 a 2000-iteration Huber solve at
    1×128² takes 6.5 ms with 16 CTAs, 8.7 with 8), else up to 8 (at
    16×128² 13.6 ms with 16, 10.7 with 8: every SM already works, and
    each CTA adds its halo rows; scripts/cluster_sizes.py tvl1)."""
    wide = O * MAX_CLUSTER_NP <= SMS
    return pd_plan(M, N, 1, itemsize,
                   max_cluster=MAX_CLUSTER_NP if wide else MAX_CLUSTER)


def _weight(alpha, f):
    """A scalar or an (M, N) map in f's dtype (maps on f's device)."""
    a = torch.as_tensor(alpha, dtype=f.dtype)
    if a.ndim == 0:
        return a
    return a.to(f.device)


def _launch(f, a, state0, *, tau, sigma, huber, lo=0.0, den=0.0, gr=0.0,
            maxiter, tol, check_every):
    """One kernel solve from ``state0`` ((u, y) or None).  Returns
    ``(u, y, iters)``."""
    check_cuda_input(f)
    dtype, dev = f.dtype, f.device
    f = f.contiguous()
    M, N = int(f.shape[-2]), int(f.shape[-1])
    O = f.numel() // (M * N)
    if a.ndim != 0 and tuple(a.shape) != (M, N):
        raise NotImplementedError(
            f"the TV-L1 kernel takes a scalar α or one (M, N) = {(M, N)} "
            f"map, got {tuple(a.shape)}")
    y_shape = f.shape[:-2] + (2,) + f.shape[-2:]
    if state0 is None:
        u, y = (s.clone() for s in cold_state(f))
    else:
        check_plane(state0[0], f.shape, f, "state0 u")
        check_plane(state0[1], y_shape, f, "state0 y")
        u, y = (s.contiguous().clone() for s in state0)
    amap = a.contiguous() if a.ndim else None
    plan = tvl1_plan(O, M, N, f.element_size())
    # the two-launch form's ū plane; u's second buffer for the early stop
    ubar = None if plan.resident else torch.empty_like(f)
    uprev = torch.empty_like(f) if tol is not None else None
    nblocks = (f.numel() + _THREADS - 1) // _THREADS
    partials = torch.empty((2 * nblocks,), dtype=dtype, device=dev)
    scal = torch.empty((3,), dtype=dtype, device=dev)
    lib = _build.library()
    fn = lib.bpl_tvl1_solve_f32 if dtype == torch.float32 \
        else lib.bpl_tvl1_solve_f64
    iters, ops = ctypes.c_int(0), ctypes.c_int(0)
    global launches, cluster_calls, device_ops
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with _build.COUNTS:
            launches += 1
            cluster_calls += int(plan.resident)
        err = fn(f.data_ptr(), u.data_ptr(), y.data_ptr(),
                 None if ubar is None else ubar.data_ptr(),
                 None if uprev is None else uprev.data_ptr(),
                 partials.data_ptr(), scal.data_ptr(),
                 None if amap is None else amap.data_ptr(),
                 0.0 if amap is not None else float(a), O, M, N,
                 plan.cluster, plan.rows, int(plan.resident), float(tau),
                 float(sigma), int(huber), float(lo), float(den), float(gr),
                 int(maxiter), int(tol is not None),
                 0.0 if tol is None else float(tol), int(check_every),
                 ctypes.byref(iters), ctypes.byref(ops), stream)
    with _build.COUNTS:
        device_ops += ops.value
    _build.check(err, f"tvl1 kernel ({plan})")
    return u, y, int(iters.value)


def _check_device(f):
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"expected a CPU or CUDA tensor, got {f.device}")


def tvl1_denoise_cuda(f, alpha, *, tau0: float = 0.99, sigma0: float = 0.99,
                      maxiter: int = 5000, tol=None, check_every: int = 500,
                      state0=None, return_dual: bool = False):
    """The plain TV-L1 form of the kernel (CUDA tensors) or its plain
    version (CPU tensors).  Returns ``u`` or, with ``return_dual``,
    ``(u, (u, y), iters)``."""
    global last_iters
    _check_device(f)
    a = _weight(alpha, f)
    state0 = as_jnp_state(state0, f.dtype)
    tau, sigma = step_sizes(tau0, sigma0, f.dtype)
    kw = dict(maxiter=int(maxiter), tol=None if tol is None else float(tol),
              check_every=int(check_every))
    if f.device.type == "cpu":
        u, y, iters = _tvl1_loop(f, a, state0, tau=tau, sigma=sigma, **kw)
    else:
        u, y, iters = _launch(f, a, state0, tau=tau, sigma=sigma,
                              huber=False, **kw)
    last_iters = iters
    if return_dual:
        return u, (u, y), iters
    return u


def tvl1_huber_denoise_cuda(f, alpha, *, gamma_d: float = 100.0,
                            gamma_r: float = 1000.0, tau0: float = 0.99,
                            sigma0: float = 0.99, maxiter: int = 5000,
                            tol=None, check_every: int = 500, state0=None,
                            return_dual: bool = False):
    """The Huber form of the kernel (CUDA tensors) or its plain version
    (CPU tensors).  Returns ``u`` or, with ``return_dual``,
    ``(u, (u, y))``."""
    global last_iters
    _check_device(f)
    a = _weight(alpha, f)
    state0 = as_jnp_state(state0, f.dtype)
    tau, sigma = step_sizes(tau0, sigma0, f.dtype)
    kw = dict(maxiter=int(maxiter), tol=None if tol is None else float(tol),
              check_every=int(check_every))
    if f.device.type == "cpu":
        u, y, iters = _tvl1_huber_loop(
            f, a, state0, gamma_d=gamma_d, gamma_r=gamma_r, tau=tau,
            sigma=sigma, **kw)
    else:
        # the prox constants in the working dtype, as the plain version
        # forms them
        lo, den = huber_prox_consts(tau, torch.tensor(gamma_d,
                                                      dtype=f.dtype))
        gr = torch.tensor(gamma_r, dtype=f.dtype)
        u, y, iters = _launch(f, a, state0, tau=tau, sigma=sigma,
                              huber=True, lo=lo, den=den, gr=gr, **kw)
    last_iters = iters
    if return_dual:
        return u, (u, y)
    return u
