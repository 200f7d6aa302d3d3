"""User-facing experiment API (counterpart of
``bpldenoising_tpu.experiments.api``).

Ported so far: :func:`scalar_bilevel_tv_learn` with ``method="tr_fused"``
(the shape of the JAX package's ``_run_fused``).  The host-driven ``tr``
method, the single-loop method, the other families, saving PNGs, quality
tables and plots, checkpointing and data parallelism are not ported yet and
raise ``NotImplementedError``, as does any ``backend`` but ``"auto"``
(:func:`check_backend`: ``device=`` chooses what runs).

Beyond the JAX surface, ``check_every`` (the inner solve's early-stop
cadence) and ``hypergrad_cfg`` (a :class:`HypergradConfig`) are parameters,
so a caller can run the flagship's settings through this entry point.
"""

from __future__ import annotations

import torch

from ..bilevel.fused import bilevel_learn_fused
from ..bilevel.harness import BilevelResult, BilevelState
from ..data import full_datasetname, testdataset
from ..models import tv_model
from ..solvers.hypergrad import HypergradConfig
from ..utils.config import Params, merge
from ..viz.log import BilevelLogEntry

__all__ = ["scalar_bilevel_tv_learn", "default_params", "bilevel_params",
           "check_backend"]

default_params = Params(
    verbose_iter=1,
    maxiter=20,
    save_results=False,
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
)

bilevel_params = Params(
    eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.1, alpha0=0.1)

_UNPORTED_FLAGS = ("save_results", "save_iterations", "checkpoint", "resume",
                   "data_parallel", "log_every")


def check_backend(backend) -> None:
    """The port's rule for the JAX package's ``backend=`` knob, in every
    family's entry points: ``"auto"`` (the JAX default) is accepted; any
    other value raises, since ``device=`` chooses what runs (``"cuda"``:
    the CUDA kernels, ``"cpu"``: their plain versions)."""
    if backend != "auto":
        raise NotImplementedError(
            f"backend={backend!r} is not ported: the port has no backends; "
            "device='cuda' runs the CUDA kernels and device='cpu' their "
            "plain versions")


def reject_unported(params) -> None:
    """Raise for every set knob the port does not implement yet."""
    for flag in _UNPORTED_FLAGS:
        if params.get(flag):
            raise NotImplementedError(f"{flag} is not ported yet")
    check_backend(params.get("backend", "auto"))


def _load(params, device):
    """Dataset → (O, M, N) tensors on ``device`` in the params dtype;
    ``color=True`` in params loads planar (O, 3, M, N) stacks."""
    true_, data = testdataset(params.dataset_name,
                              color=bool(params.get("color")))
    n = int(params.num_samples)
    dt = getattr(torch, str(params.get("dtype", "float64")))
    return (torch.as_tensor(true_[:n], dtype=dt).to(device),
            torch.as_tensor(data[:n], dtype=dt).to(device))


def _fused_to_result(res) -> BilevelResult:
    """FusedResult (log matrix) → host BilevelResult whose
    ``state.log`` holds one BilevelLogEntry per outer iteration, as the JAX
    package's ``_fused_to_result`` builds it.  Every ``time`` is 0.0:
    segmented dispatch, which times the iterations, is not ported."""
    st = BilevelState()
    k = int(res.iterations)
    for i, row in enumerate(res.log[:k].tolist()):
        st.log.append(BilevelLogEntry(
            i + 1, 0.0, *row[:4], adjoint_cg_iters=row[4],
            adjoint_cg_converged=row[5]))
    return BilevelResult(x=res.x.numpy(), u=res.u.cpu().numpy(),
                         state=st, cost=float(res.cost),
                         g_norm=float(res.g_norm), iterations=k)


def _run_fused(params, device):
    reject_unported(params)
    ds = _load(params, device)
    res = bilevel_learn_fused(
        ds, xinit=params.alpha0, params=params, model=tv_model(),
        inner_maxiter=int(params.inner_maxiter),
        inner_tol=params.get("inner_tol"),
        check_every=int(params.check_every), delta_t=1e-6,
        cfg=params.hypergrad_cfg, device=device)
    return _fused_to_result(res)


def scalar_bilevel_tv_learn(visualise: bool = False, device="cuda",
                            **kwargs) -> BilevelResult:
    """Learn one scalar TV weight on a dataset with the trust region.

    Only ``method="tr_fused"`` is ported.  ``device="cuda"`` runs the CUDA
    kernels; ``device="cpu"`` runs their plain versions.
    """
    if visualise:
        raise NotImplementedError("visualise is not ported yet")
    params = merge(default_params, bilevel_params, kwargs)
    params = params | dict(dataset_name=full_datasetname(params.dataset_name))
    if params.get("method") != "tr_fused":
        raise NotImplementedError(
            f"method={params.get('method')!r} is not ported yet; use "
            "method='tr_fused'")
    return _run_fused(params, device)
