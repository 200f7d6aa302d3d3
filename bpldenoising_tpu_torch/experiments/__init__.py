from .api import LearnResult, scalar_bilevel_tv_learn
from .tgv import (TGVDenoise, patch_bilevel_tgv_learn,
                  scalar_bilevel_tgv_learn)
from .tvl1 import (TVL1Denoise, patch_bilevel_tvl1_learn,
                   scalar_bilevel_tvl1_learn)

__all__ = ["scalar_bilevel_tv_learn", "scalar_bilevel_tgv_learn",
           "patch_bilevel_tgv_learn", "TGVDenoise", "scalar_bilevel_tvl1_learn",
           "patch_bilevel_tvl1_learn", "TVL1Denoise", "LearnResult"]
