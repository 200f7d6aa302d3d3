"""Hand state from the JAX package to the port.

:func:`from_jax_state` turns arrays as the JAX package returns them (α,
a warm PDPS state ``(u, ys)`` with ys a K-tuple of (O, 2, M, N)
duals (K = 3 for the sum of regularizers, in the order of the model's
operators), adjoint states ``p``, a warm TGV² solver
state ``(u, w, p, q)`` with w, p shaped (O, 2, M, N) and q (O, 3, M, N) in
the plane order (rr, cc, rc), the TGV adjoint multiplier λ of shape
(O, 3, M, N), a warm TV-L1 solver state ``(u, y)`` with y (O, 2, M, N) or
the Pallas kernels' ``(u, px, py)`` (the port's TV-L1 solvers take both and
return ``(u, y)``), the TV-L1 adjoint p of shape (O, M, N), a warm VTV
solver state, the jnp path's ``(u, (y,))`` with u (O, C, M, N) and y
(O, C, 2, M, N) or the Pallas kernel's ``(u, px, py)`` with px, py
(O, C, M, N) (the port's VTV solver takes both and returns ``(u, (y,))``),
the VTV adjoint multiplier λ of shape (O, C, M, N), the single-loop
learner's carry ``(u, ys, p, z, (m, v), t)`` with u, p (O, M, N), ys a
K-tuple of (O, 2, M, N) duals, z = log α and Adam's moments m, v in the
parameter's shape and the 0-d step counter t (the port's
``bilevel.first_order._single_loop_impl`` resumes from it as
``carry0``), the other families' single-loop carries, which the port's
``_single_loop_{tgv,tvl1,vtv}_impl`` resume from likewise: TGV²
``((u, w, p, q), λ, z, (m, v), t)`` with λ (O, 3, M, N), TV-L1
``(u, y, p, z, (m, v), t)`` and VTV ``(u, y, λ, z, (m, v), t)`` with u, λ
(O, C, M, N) and y (O, C, 2, M, N); any nesting of tuples and lists) into
the port's tensors, so that both packages can be fed the same state.  It
reads each leaf through ``numpy.asarray`` and never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_state"]


def from_jax_state(tree, device="cuda", dtype=None):
    """Map every array leaf of ``tree`` to a tensor on ``device``
    (``dtype`` defaults to the leaf's own); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        out = [from_jax_state(t, device, dtype) for t in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    arr = np.array(tree, copy=True)
    t = torch.from_numpy(arr)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)
