from .first_order import (SingleLoopResult, single_loop_learn,
                          single_loop_sumregs_learn, single_loop_tv_learn)
from .first_order_cuda import (single_loop_cuda, single_loop_cuda_tiled,
                               single_loop_tv_cuda)
from .fused import FusedResult, bilevel_learn_fused
from .fused_tgv import bilevel_learn_tgv_fused, tgv_param_layout
from .fused_tvl1 import bilevel_learn_tvl1_fused, tvl1_param_layout
from .fused_vtv import bilevel_learn_vtv_fused, vtv_param_layout
from .harness import BilevelResult, BilevelState

__all__ = ["bilevel_learn_fused", "bilevel_learn_tgv_fused",
           "tgv_param_layout", "bilevel_learn_tvl1_fused",
           "tvl1_param_layout", "bilevel_learn_vtv_fused",
           "vtv_param_layout", "FusedResult", "BilevelResult",
           "BilevelState", "single_loop_learn", "single_loop_tv_learn",
           "single_loop_sumregs_learn", "SingleLoopResult",
           "single_loop_cuda", "single_loop_cuda_tiled",
           "single_loop_tv_cuda"]
