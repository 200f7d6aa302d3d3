"""Differentiable denoising layers by implicit differentiation
(counterpart of ``bpldenoising_tpu.solvers.implicit``).

:func:`diff_tv_denoise` and :func:`diff_denoise` wrap the PDPS solver in a
``torch.autograd.Function`` whose backward applies the implicit function
theorem to the γ-Huber-smoothed optimality system instead of unrolling the
solver's iterations.  For u*(f, α) = argmin ½‖u−f‖² + Σₖ‖αₖGₖu‖₂,₁ with
KKT residual F(u, f, α) = u − f + Σₖ Gₖᵀ qₖ(Gₖu, αₖ) = 0:

* ∂F/∂u = M (the SPD system of :func:`.hypergrad.build_reg_system`),
* ∂F/∂f = −I  ⟹  vjp_f(v) = M⁻¹v,
* vjp_αₖ(v) = −⟨Gₖ M⁻¹v, dual field⟩,

so one Jacobi-preconditioned CG gives the cotangents of every input.

The forward is :func:`.pdps.denoise_pdps` where ``f`` lives: kernel A on a
CUDA tensor, the plain iteration on a CPU tensor.  The backward CG is
plain PyTorch on either device, as the JAX package runs it in jnp.  One
(M, N) image solves one joint system (``cg``); an (O, M, N) stack solves
its images' systems side by side with per-image CG dots (``cg_batched``),
which is what ``jax.vmap`` of the JAX layer gives, and the weights'
cotangents sum over the images.  The TGV², TV-L1 and VTV layers
(:mod:`.tgv`, :mod:`.tvl1_huber`, :mod:`.vtv`) run on
:class:`ImplicitLayer` too.
"""

from __future__ import annotations

import torch

from ..models import DenoiseModel, tv_model
from ..ops import scalarprod
from ..utils.config import check_backend
from .hypergrad import HypergradConfig, _defaults, build_reg_system
from .krylov import cg, cg_batched
from .pdps import denoise_pdps

__all__ = ["ImplicitLayer", "diff_denoise", "diff_tv_denoise",
           "make_diff_denoise", "check_layer_backend"]


class ImplicitLayer(torch.autograd.Function):
    """``u = ImplicitLayer.apply(solve, cotangents, f, *alphas)``.

    ``solve(f, alphas) -> (u, extra)`` runs the forward solve (``extra``:
    what else the backward needs, such as TGV²'s w);
    ``cotangents(u, f, alphas, extra, v) -> (df, dalphas)`` solves the
    adjoint system once for the loss cotangent ``v`` (shaped like u) and
    returns the cotangent of f and one per weight, each shaped like its
    weight.  The backward returns only what ``ctx.needs_input_grad`` asks
    for, each on its input's device and in its dtype."""

    @staticmethod
    def forward(ctx, solve, cotangents, f, *alphas):
        u, extra = solve(f, alphas)
        ctx.cotangents, ctx.extra = cotangents, extra
        ctx.save_for_backward(u, f, *alphas)
        return u

    @staticmethod
    def backward(ctx, v):
        u, f, *alphas = ctx.saved_tensors
        need_f, *need_a = ctx.needs_input_grad[2:]
        if not (need_f or any(need_a)):
            return (None,) * (3 + len(alphas))
        df, dalphas = ctx.cotangents(u, f, tuple(alphas), ctx.extra,
                                     v.contiguous())
        dalphas = tuple(g.to(device=a.device, dtype=a.dtype) if need else None
                        for g, a, need in zip(dalphas, alphas, need_a))
        return (None, None, df if need_f else None) + dalphas


def check_layer_backend(backend, interpret) -> None:
    """The JAX layers' ``backend=`` and ``interpret=`` keywords: ``"auto"``
    and False run (``f``'s device chooses what runs); anything else
    raises, as :func:`..utils.config.check_backend` does."""
    check_backend(backend)
    if interpret:
        raise NotImplementedError(
            "interpret=True is not ported: the port has no Pallas kernels; "
            "device='cuda' runs the CUDA kernels and device='cpu' their "
            "plain versions")


def weight_like(alpha, f):
    """A weight as a tensor in ``f``'s dtype (differentiably): a map on
    ``f``'s device, a scalar where it is (the kernels read it once)."""
    a = torch.as_tensor(alpha)
    if a.ndim >= 2:
        return a.to(device=f.device, dtype=f.dtype)
    return a.to(dtype=f.dtype)


def reduce_like(gmap, alpha):
    """A per-pixel sensitivity map → the cotangent of the weight ``alpha``:
    summed over the batch for an (M, N) map, over everything for a
    scalar."""
    if alpha.ndim >= 2:
        return torch.sum(gmap.reshape((-1,) + tuple(gmap.shape[-2:])), dim=0)
    return torch.sum(gmap)


def _vjp_solve(u, v, alphas, model: DenoiseModel, cfg: HypergradConfig):
    """p = M⁻¹v for the γ-smoothed system at u (one (M, N) image: one CG;
    a stack: per-image CG dots) and the per-k dual fields."""
    _, _, cg_tol = _defaults(u.dtype, cfg)
    M_apply, inv_diag, fields = build_reg_system(u, alphas, model, cfg.gamma)
    kw = dict(tol=cg_tol, maxiter=cfg.cg_maxiter, M=lambda r: inv_diag * r)
    if v.ndim == 2:
        p, _ = cg(M_apply, v, **kw)
    else:
        p, _ = cg_batched(M_apply, v, item_ndim=2, **kw)
    return p, fields


def _alpha_cotangent(p, fields, alphas, model):
    """Per-k cotangent in the shape of αₖ (scalar or map)."""
    return tuple(reduce_like(-scalarprod(op.apply(p), field), a)
                 for op, field, a in zip(model.ops, fields, alphas))


def make_diff_denoise(model: DenoiseModel, maxiter: int = 5000,
                      cfg: HypergradConfig = HypergradConfig()):
    """Build a differentiable denoiser ``(f, alphas) -> u`` on ``model``
    (``alphas`` a K-tuple of scalars or (M, N) maps in ``f``'s dtype)."""

    def solve(f, alphas):
        return denoise_pdps(f, alphas, model, maxiter=maxiter), None

    def cotangents(u, f, alphas, extra, v):
        p, fields = _vjp_solve(u, v, alphas, model, cfg)
        return p, _alpha_cotangent(p, fields, alphas, model)

    def layer(f, alphas):
        return ImplicitLayer.apply(solve, cotangents, f, *alphas)

    return layer


_TV = tv_model()


def diff_tv_denoise(f, alpha, maxiter: int = 5000):
    """Differentiable TV denoising of one (M, N) image or an (O, M, N)
    stack where ``f`` lives: ``torch.autograd`` flows through ``f`` and
    ``alpha`` (scalar or (M, N) map) at the cost of one extra CG solve,
    no unrolling."""
    f = torch.as_tensor(f)
    return make_diff_denoise(_TV, maxiter=maxiter)(f, (weight_like(alpha,
                                                                   f),))


def diff_denoise(f, alphas, model: DenoiseModel, maxiter: int = 5000,
                 cfg: HypergradConfig = HypergradConfig()):
    """General K-block differentiable denoiser; ``alphas`` as
    :meth:`..models.DenoiseModel.canonical_alphas` reads them."""
    f = torch.as_tensor(f)
    alphas = tuple(weight_like(a, f) for a in model.canonical_alphas(alphas))
    return make_diff_denoise(model, maxiter=maxiter, cfg=cfg)(f, alphas)
