from .first_order import (SingleLoopResult, single_loop_learn,
                          single_loop_sumregs_learn, single_loop_tv_learn)
from .first_order_cuda import (single_loop_cuda, single_loop_cuda_tiled,
                               single_loop_tv_cuda)
from .first_order_tgv import single_loop_tgv_learn
from .first_order_tgv_cuda import single_loop_tgv_cuda
from .first_order_tvl1 import single_loop_tvl1_learn
from .first_order_tvl1_cuda import single_loop_tvl1_cuda
from .first_order_vtv import single_loop_vtv_learn
from .first_order_vtv_cuda import single_loop_vtv_cuda
from .fused import FusedResult, bilevel_learn_fused
from .fused_tgv import bilevel_learn_tgv_fused, tgv_param_layout
from .fused_tvl1 import bilevel_learn_tvl1_fused, tvl1_param_layout
from .fused_vtv import bilevel_learn_vtv_fused, vtv_param_layout
from .harness import BilevelResult, BilevelState, LiveView, bilevel_iterate
from .trust_region import TRModel, bilevel_learn, dogleg_box

__all__ = ["bilevel_learn_fused", "bilevel_learn_tgv_fused",
           "tgv_param_layout", "bilevel_learn_tvl1_fused",
           "tvl1_param_layout", "bilevel_learn_vtv_fused",
           "vtv_param_layout", "FusedResult", "BilevelResult",
           "BilevelState", "single_loop_learn", "single_loop_tv_learn",
           "single_loop_sumregs_learn", "SingleLoopResult",
           "single_loop_cuda", "single_loop_cuda_tiled",
           "single_loop_tv_cuda", "single_loop_tgv_learn",
           "single_loop_tgv_cuda", "single_loop_tvl1_learn",
           "single_loop_tvl1_cuda", "single_loop_vtv_learn",
           "single_loop_vtv_cuda", "bilevel_learn", "bilevel_iterate",
           "TRModel", "dogleg_box", "LiveView"]
