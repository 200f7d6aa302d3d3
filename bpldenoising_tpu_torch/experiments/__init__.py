from .api import LearnResult, scalar_bilevel_tv_learn
from .tgv import (TGVDenoise, patch_bilevel_tgv_learn,
                  scalar_bilevel_tgv_learn)

__all__ = ["scalar_bilevel_tv_learn", "scalar_bilevel_tgv_learn",
           "patch_bilevel_tgv_learn", "TGVDenoise", "LearnResult"]
