"""PyTorch/CUDA port of ``bpldenoising_tpu`` for NVIDIA Hopper (H100).

The JAX package ``bpldenoising_tpu`` is the reference; this package keeps
its module names where that helps a reader find the counterpart.  Plain
tensor code is PyTorch; the TPU's Pallas kernels on the ported path are
hand-written CUDA C++ under ``csrc/`` (built with ``nvcc`` at first use and
bound with ``ctypes``, see :mod:`._build`).

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.

Ported so far: every learn of the five families (TV, patch TV, the sums
of regularizers, TGV², TV-L1 and color VTV, scalar and patch) with every
method — the host-driven trust region ``method="tr"`` (the default;
:func:`bilevel.trust_region.bilevel_learn` over the learning functions of
:mod:`.learning`), the fused trust region ``method="tr_fused"`` and the
single-loop first-order learner ``method="single_loop"`` (with its
library functions ``single_loop_*_learn`` and their CUDA counterparts) —
each ending in ``save_results`` (the log, the SSIM/PSNR table and the PNGs
under ``output/<dataset>/``; ``save_results=True`` by default); the
denoisers :func:`experiments.api.TVDenoise`, ``TGVDenoise``,
``TVL1Denoise`` and ``VTVDenoise``; the validations ``validate_*`` and
the cost sweeps ``generate_*_cost`` with their plots in every family; the
live view (``visualise=True`` with ``method="tr"``); checkpoint and
resume, segmented dispatch of the fused trust region (``log_every``) and
profiler traces (:mod:`.utils`); the differentiable denoising layers
``diff_tv_denoise``, ``diff_denoise``, ``diff_tgv_denoise``,
``diff_tvl1_denoise`` and ``diff_vtv_denoise`` (``torch.autograd`` through
the kernels' forward solves by implicit differentiation); and the
command line, ``python -m bpldenoising_tpu_torch``.  The learns return the
JAX package's :class:`bilevel.harness.BilevelResult`.
"""

from .bilevel.first_order import (single_loop_learn,
                                  single_loop_sumregs_learn,
                                  single_loop_tv_learn)
from .bilevel.first_order_tgv import single_loop_tgv_learn
from .bilevel.first_order_tvl1 import single_loop_tvl1_learn
from .bilevel.first_order_vtv import single_loop_vtv_learn
from .bilevel.trust_region import TRModel, bilevel_learn, dogleg_box
from .experiments import (L2CostFunction, TGVDenoise, TVDenoise,
                          TVL1Denoise, VTVDenoise, generate_2d_cost_plot,
                          generate_2d_tv_cost, generate_cost_plot,
                          generate_scalar_tv_cost, generate_tgv_cost,
                          generate_tgv_cost_plot, generate_tvl1_cost,
                          generate_tvl1_cost_plot, generate_vtv_cost,
                          generate_vtv_cost_plot,
                          patch_bilevel_sumregs_learn,
                          patch_bilevel_tgv_learn, patch_bilevel_tv_learn,
                          patch_bilevel_tvl1_learn, patch_bilevel_vtv_learn,
                          save_results, scalar_bilevel_sumregs_learn,
                          scalar_bilevel_tgv_learn, scalar_bilevel_tv_learn,
                          scalar_bilevel_tvl1_learn,
                          scalar_bilevel_vtv_learn,
                          validate_sumregs_parameter,
                          validate_tgv_parameter, validate_tv_parameter,
                          validate_tvl1_parameter, validate_vtv_parameter)
from .learning import (make_sumregs_learning_function,
                       make_tgv_learning_function, make_tv_learning_function,
                       make_tvl1_learning_function,
                       make_vtv_learning_function, sumregs_learning_function,
                       tgv_learning_function, tv_learning_function,
                       vtv_learning_function)
from .models import sumregs_model, tv_model, vtv_model
from .solvers import (denoise_pdps, diff_denoise, diff_tgv_denoise,
                      diff_tv_denoise, diff_tvl1_denoise, diff_vtv_denoise,
                      sumregs_denoise, tgv_denoise_pdps, tv_denoise,
                      tvl1_denoise, tvl1_energy, tvl1_huber_denoise,
                      vtv_denoise)
from .solvers.lbfgs import LBFGSModel

__all__ = ["scalar_bilevel_tv_learn", "patch_bilevel_tv_learn",
           "scalar_bilevel_sumregs_learn", "patch_bilevel_sumregs_learn",
           "single_loop_learn", "single_loop_tv_learn",
           "single_loop_sumregs_learn", "single_loop_tgv_learn",
           "single_loop_tvl1_learn", "single_loop_vtv_learn",
           "scalar_bilevel_tgv_learn",
           "patch_bilevel_tgv_learn", "TGVDenoise", "scalar_bilevel_tvl1_learn",
           "patch_bilevel_tvl1_learn", "TVL1Denoise", "tvl1_denoise",
           "tvl1_energy", "tvl1_huber_denoise", "scalar_bilevel_vtv_learn",
           "patch_bilevel_vtv_learn", "VTVDenoise", "vtv_denoise",
           "tv_denoise", "sumregs_denoise", "denoise_pdps", "tv_model",
           "sumregs_model", "vtv_model", "bilevel_learn", "TRModel",
           "dogleg_box", "LBFGSModel", "make_tv_learning_function",
           "make_sumregs_learning_function", "make_tgv_learning_function",
           "make_tvl1_learning_function", "make_vtv_learning_function",
           "TVDenoise", "L2CostFunction", "save_results",
           "validate_tv_parameter", "validate_sumregs_parameter",
           "validate_tgv_parameter", "validate_tvl1_parameter",
           "validate_vtv_parameter", "generate_scalar_tv_cost",
           "generate_cost_plot", "generate_2d_tv_cost",
           "generate_2d_cost_plot", "generate_tgv_cost",
           "generate_tgv_cost_plot", "generate_tvl1_cost",
           "generate_tvl1_cost_plot", "generate_vtv_cost",
           "generate_vtv_cost_plot", "diff_tv_denoise", "diff_denoise",
           "diff_tgv_denoise", "diff_tvl1_denoise", "diff_vtv_denoise",
           "tv_learning_function", "sumregs_learning_function",
           "tgv_learning_function", "vtv_learning_function",
           "tgv_denoise_pdps"]
