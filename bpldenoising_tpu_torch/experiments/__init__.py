from .api import LearnResult, scalar_bilevel_tv_learn

__all__ = ["scalar_bilevel_tv_learn", "LearnResult"]
