from .api import (patch_bilevel_sumregs_learn, patch_bilevel_tv_learn,
                  scalar_bilevel_sumregs_learn, scalar_bilevel_tv_learn)
from .tgv import (TGVDenoise, patch_bilevel_tgv_learn,
                  scalar_bilevel_tgv_learn)
from .tvl1 import (TVL1Denoise, patch_bilevel_tvl1_learn,
                   scalar_bilevel_tvl1_learn)
from .vtv import (VTVDenoise, patch_bilevel_vtv_learn,
                  patch_vtv_bilevel_params, scalar_bilevel_vtv_learn,
                  vtv_bilevel_params)

__all__ = ["scalar_bilevel_tv_learn", "patch_bilevel_tv_learn",
           "scalar_bilevel_sumregs_learn", "patch_bilevel_sumregs_learn",
           "scalar_bilevel_tgv_learn",
           "patch_bilevel_tgv_learn", "TGVDenoise", "scalar_bilevel_tvl1_learn",
           "patch_bilevel_tvl1_learn", "TVL1Denoise", "scalar_bilevel_vtv_learn",
           "patch_bilevel_vtv_learn", "VTVDenoise", "vtv_bilevel_params",
           "patch_vtv_bilevel_params"]
