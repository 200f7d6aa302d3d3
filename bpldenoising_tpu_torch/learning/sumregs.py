"""Sum-of-regularizers learning function, K = 3 gradient operators
(counterpart of ``bpldenoising_tpu.learning.sumregs``).

Weights α ∈ ℝ³ or an (m, n, 3) patch stack, with the forward, backward and
centred difference operators; the same step as :mod:`.tv`
(:func:`.tv.tv_step`: kernel A with K = 3, kernel B's K = 3 or gradient-map
form) and the same warm-start factory.  The exact gradient runs where
Δ > Δt = 1e-3 (TV's is 1e-6).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import sumregs_model
from ..ops import PatchOp
from ..solvers.hypergrad import HypergradConfig
from ..utils.config import check_backend
from .cache import dataset_tensors
from .tv import make_learning_function, tv_step

__all__ = ["sumregs_learning_function", "make_sumregs_learning_function"]

_MODEL = sumregs_model()


def sumregs_learning_function(x, ds, delta, *, delta_t: float = 1e-3,
                              maxiter: int = 5000,
                              cfg: HypergradConfig = HypergradConfig(),
                              backend: str = "auto",
                              solver_kwargs: Optional[dict] = None,
                              p0=None, s0=None, return_aux: bool = False,
                              device="cuda"):
    """L4 learning function for the three-regularizer model: ``x`` is a
    (3,) weight vector or an (m, n, 3) patch stack; the rest as in
    :func:`.tv.tv_learning_function`.  Returns ``(u, cost, grad)``,
    ``grad`` shaped like ``x`` (``(u, cost, grad, p, state, info)`` with
    ``return_aux``)."""
    check_backend(backend)
    utrue, f, squeeze = dataset_tensors(ds, device)
    x = torch.as_tensor(np.asarray(x), dtype=utrue.dtype)
    method = "exact" if float(delta) > delta_t else "reg"
    if x.ndim == 1 and x.shape[0] == 3:
        pop = None
    elif x.ndim == 3 and x.shape[-1] == 3:
        pop = PatchOp.for_image(x[..., 0], f[0])
    else:
        raise ValueError(f"sumregs parameter must be (3,) or (m, n, 3), "
                         f"got {tuple(x.shape)}")
    u, cost, g, p, state, info = tv_step(
        x, utrue, f, p0, s0, model=_MODEL, method=method,
        maxiter=int(maxiter), cfg=cfg, pop=pop, solver_kwargs=solver_kwargs)
    if squeeze:
        u = u[0]
    if return_aux:
        return u, cost, g, p, state, info
    return u, cost, g


def make_sumregs_learning_function(**defaults):
    """Sum-of-regularizers factory for the L4 contract (the warm starts of
    :func:`.tv.make_learning_function`); ``device`` defaults to
    ``"cuda"``."""
    return make_learning_function(sumregs_learning_function, 1e-3,
                                  **defaults)
