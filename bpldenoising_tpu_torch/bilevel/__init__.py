from .fused import FusedResult, bilevel_learn_fused

__all__ = ["bilevel_learn_fused", "FusedResult"]
