"""Kernel B: the augmented-Lagrangian hypergradient with Jacobi-PCG as a
CUDA kernel (``csrc/hypergrad.cu``), in its exact and γ-regularized forms,
replacing the TPU kernel
``bpldenoising_tpu/solvers/hypergrad_pallas.py::_hg_kernel``.

:func:`exact_hypergrad_cuda` and :func:`reg_hypergrad_cuda` take the
arguments of the plain :func:`.hypergrad.exact_hypergrad` and
:func:`.hypergrad.reg_hypergrad`.  For tensors on the CPU they run those;
for CUDA tensors they launch the kernel, for the models and weights that
kernel A takes (:func:`.pdps_cuda.kernel_blocks`: K ≤ 3 forward, backward
or centred difference gradients, each weight a scalar or an (M, N) map),
and return K scalar gradients or, with ``want_maps``, K per-pixel gradient
maps shaped like ``u``.  The CG inner products run over the whole batch
(one joint system), as in the plain version.

A call is one cooperative launch, sized to the card's co-resident CTAs,
that runs the whole AL solve with the CG stop test on the device, and one
device→host read of its stats (``device_ops`` counts both); a launch or
occupancy query the card refuses raises.  The launch path checks the
inputs before the device, so a bad shape, dtype, weight or model raises
its own error, and CPU tensors never reach the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..models import DenoiseModel
from .hypergrad import (HypergradConfig, _defaults, exact_hypergrad,
                        reg_hypergrad)
from .krylov import KrylovInfo
from .pdps_cuda import check_cuda_input, check_plane, kernel_blocks

__all__ = ["exact_hypergrad_cuda", "reg_hypergrad_cuda", "launches",
           "device_ops", "host_reads"]

#: calls that launched the CUDA kernel (exact and regularized forms)
launches = 0
#: device operations those calls issued, as the C side counts them: kernel
#: launches and device→host reads (one cooperative launch and one read of
#: the stats a call)
device_ops = 0
#: the device→host reads among them
host_reads = 0
#: CG iterations of all solves of the last kernel call (work accounting)
last_total_cg_iters = 0
#: CTAs of the last kernel call's cooperative launch
last_grid = 0


def _run(u, utrue, alphas, model, cfg, want_maps, p0, reg: bool):
    check_plane(utrue, u.shape, u, "utrue")
    if p0 is not None:
        check_plane(p0, u.shape, u, "p0")
    K, kinds, scalars, addrs, _maps = kernel_blocks(model, alphas, u)
    check_cuda_input(u)
    dtype = u.dtype
    act_tol, mu, cg_tol = _defaults(dtype, cfg)
    u = u.contiguous()
    utrue = utrue.contiguous()
    # p starts from p0 (or 0) inside the launch
    p0 = None if p0 is None else p0.contiguous()
    p = torch.empty_like(u)
    M, N = int(u.shape[-2]), int(u.shape[-1])
    O = u.numel() // (M * N)
    lib = _build.library()
    n = u.numel()
    nblocks = (n + 255) // 256
    work = torch.empty((lib.bpl_hypergrad_planes(K), n), dtype=dtype,
                       device=u.device)
    partials = torch.empty((lib.bpl_hypergrad_regions() * nblocks,),
                           dtype=dtype, device=u.device)
    scal = torch.empty((lib.bpl_hypergrad_slots(),), dtype=dtype,
                       device=u.device)
    gmaps = torch.empty((K,) + tuple(u.shape), dtype=dtype,
                        device=u.device) if want_maps else None
    n_stats = lib.bpl_hypergrad_stats()
    dstats = torch.empty((n_stats,), dtype=torch.float64, device=u.device)
    stats = (ctypes.c_double * n_stats)()
    ops = (ctypes.c_int * 2)()
    grid = ctypes.c_int(0)
    fn = lib.bpl_hypergrad_f32 if dtype == torch.float32 \
        else lib.bpl_hypergrad_f64
    global launches, device_ops, host_reads, last_total_cg_iters, last_grid
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        with _build.COUNTS:
            launches += 1
        err = fn(u.data_ptr(), utrue.data_ptr(),
                 None if p0 is None else p0.data_ptr(), p.data_ptr(),
                 work.data_ptr(), partials.data_ptr(), scal.data_ptr(),
                 None if gmaps is None else gmaps.data_ptr(),
                 dstats.data_ptr(), O, M, N, K, kinds, scalars, addrs,
                 float(act_tol), float(cfg.gamma), float(mu), float(cg_tol),
                 int(cfg.al_iters), int(cfg.cg_maxiter), int(reg), stats,
                 ops, ctypes.byref(grid), stream)
    with _build.COUNTS:
        device_ops += ops[0] + ops[1]
        host_reads += ops[1]
    last_grid = grid.value
    _build.check(err, "hypergradient kernel (cooperative launch)")
    if want_maps:
        grads = tuple(gmaps.unbind(0))
    else:
        g0 = lib.bpl_hypergrad_grad_slot()
        grads = tuple(scal[g0:g0 + K].unbind(0))
    rr = torch.tensor(stats[0], dtype=dtype)
    bb = torch.tensor(stats[1], dtype=dtype)
    resnorm = torch.sqrt(rr)
    bnorm = torch.clamp(torch.sqrt(bb), min=torch.finfo(dtype).tiny)
    info = KrylovInfo(int(stats[2]), resnorm, resnorm <= cg_tol * bnorm)
    last_total_cg_iters = int(stats[3])
    return grads, p, info


def exact_hypergrad_cuda(u, utrue, alphas, model: DenoiseModel,
                         cfg: HypergradConfig = HypergradConfig(),
                         want_maps: bool = False, p0=None):
    """Kernel B, exact form (CUDA tensors), or the plain
    :func:`.hypergrad.exact_hypergrad` (CPU tensors)."""
    if u.device.type == "cpu":
        return exact_hypergrad(u, utrue, alphas, model, cfg, want_maps, p0)
    return _run(u, utrue, alphas, model, cfg, want_maps, p0, reg=False)


def reg_hypergrad_cuda(u, utrue, alphas, model: DenoiseModel,
                       cfg: HypergradConfig = HypergradConfig(),
                       want_maps: bool = False, p0=None):
    """Kernel B, γ-regularized form (CUDA tensors), or the plain
    :func:`.hypergrad.reg_hypergrad` (CPU tensors)."""
    if u.device.type == "cpu":
        return reg_hypergrad(u, utrue, alphas, model, cfg, want_maps, p0)
    return _run(u, utrue, alphas, model, cfg, want_maps, p0, reg=True)
