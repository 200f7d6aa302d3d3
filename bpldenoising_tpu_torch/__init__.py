"""PyTorch/CUDA port of ``bpldenoising_tpu`` for NVIDIA Hopper (H100).

The JAX package ``bpldenoising_tpu`` is the reference; this package keeps
its module names where that helps a reader find the counterpart.  Plain
tensor code is PyTorch; the TPU's Pallas kernels on the ported path are
hand-written CUDA C++ under ``csrc/`` (built with ``nvcc`` at first use and
bound with ``ctypes``, see :mod:`._build`).

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.

Ported so far: the TV-family trust-region learns with
``method="tr_fused"``: the scalar-TV flagship
:func:`experiments.api.scalar_bilevel_tv_learn`, the patch TV
:func:`experiments.api.patch_bilevel_tv_learn` and the sum of regularizers
:func:`experiments.api.scalar_bilevel_sumregs_learn` and
:func:`experiments.api.patch_bilevel_sumregs_learn` (dataset form), with
:func:`solvers.pdps.tv_denoise` and :func:`solvers.pdps.sumregs_denoise`
(scalar or map weights), and the TGV² trust-region learn,
:func:`experiments.tgv.scalar_bilevel_tgv_learn` and
:func:`experiments.tgv.patch_bilevel_tgv_learn` with ``method="tr_fused"``,
with :func:`experiments.tgv.TGVDenoise`, and the TV-L1 trust-region learn on
the Huber-smoothed surrogate, :func:`experiments.tvl1.scalar_bilevel_tvl1_learn`
and :func:`experiments.tvl1.patch_bilevel_tvl1_learn` with
``method="tr_fused"``, with :func:`experiments.tvl1.TVL1Denoise`, and the
color VTV trust-region learn, :func:`experiments.vtv.scalar_bilevel_vtv_learn`
and :func:`experiments.vtv.patch_bilevel_vtv_learn` with
``method="tr_fused"``, with :func:`experiments.vtv.VTVDenoise`, and the
single-loop first-order learner (``method="single_loop"``) of
:func:`experiments.api.scalar_bilevel_tv_learn`,
:func:`experiments.api.patch_bilevel_tv_learn`,
:func:`experiments.api.scalar_bilevel_sumregs_learn` and
:func:`experiments.api.patch_bilevel_sumregs_learn`, with its library
functions :func:`bilevel.first_order.single_loop_learn` and
:func:`bilevel.first_order_cuda.single_loop_cuda` (and ``_tiled``), and
the single-loop learners of the other three families
(``method="single_loop"`` in the TGV, TV-L1 and VTV learns), with
:func:`bilevel.first_order_tgv.single_loop_tgv_learn`,
:func:`bilevel.first_order_tvl1.single_loop_tvl1_learn`,
:func:`bilevel.first_order_vtv.single_loop_vtv_learn` and their CUDA
counterparts ``single_loop_{tgv,tvl1,vtv}_cuda``.  The learns return the
JAX package's :class:`bilevel.harness.BilevelResult`.
"""

from .bilevel.first_order import (single_loop_learn,
                                  single_loop_sumregs_learn,
                                  single_loop_tv_learn)
from .bilevel.first_order_tgv import single_loop_tgv_learn
from .bilevel.first_order_tvl1 import single_loop_tvl1_learn
from .bilevel.first_order_vtv import single_loop_vtv_learn
from .experiments.api import (patch_bilevel_sumregs_learn,
                              patch_bilevel_tv_learn,
                              scalar_bilevel_sumregs_learn,
                              scalar_bilevel_tv_learn)
from .experiments.tgv import (TGVDenoise, patch_bilevel_tgv_learn,
                              scalar_bilevel_tgv_learn)
from .experiments.tvl1 import (TVL1Denoise, patch_bilevel_tvl1_learn,
                               scalar_bilevel_tvl1_learn)
from .experiments.vtv import (VTVDenoise, patch_bilevel_vtv_learn,
                              scalar_bilevel_vtv_learn)
from .models import sumregs_model, tv_model, vtv_model
from .solvers import (denoise_pdps, sumregs_denoise, tv_denoise,
                      tvl1_denoise, tvl1_energy, tvl1_huber_denoise,
                      vtv_denoise)

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
           "sumregs_model",
           "vtv_model"]
