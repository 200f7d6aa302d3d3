from .fused import FusedResult, bilevel_learn_fused
from .fused_tgv import bilevel_learn_tgv_fused, tgv_param_layout

__all__ = ["bilevel_learn_fused", "bilevel_learn_tgv_fused",
           "tgv_param_layout", "FusedResult"]
