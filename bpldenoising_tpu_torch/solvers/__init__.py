from .hypergrad import HypergradConfig, exact_hypergrad, reg_hypergrad
from .implicit import diff_denoise, diff_tv_denoise, make_diff_denoise
from .krylov import KrylovInfo, cg, cg_batched
from .pdps import (PDPS_DEFAULTS, denoise_pdps, sumregs_denoise, tv_denoise,
                   vtv_denoise)
from .tgv import (TGV_PDPS_DEFAULTS, diff_tgv_denoise, make_diff_tgv_denoise,
                  tgv_denoise_pdps, tgv_energy, tgv_implicit_cotangents)
from .tvl1 import tvl1_denoise, tvl1_energy
from .tvl1_huber import (diff_tvl1_denoise, make_diff_tvl1_denoise,
                         tvl1_huber_denoise, tvl1_huber_energy,
                         tvl1_huber_hypergrad,
                         tvl1_huber_implicit_cotangents)
from .vtv import (diff_vtv_denoise, make_diff_vtv_denoise,
                  vtv_implicit_cotangents)

__all__ = ["denoise_pdps", "tv_denoise", "sumregs_denoise", "PDPS_DEFAULTS", "HypergradConfig",
           "exact_hypergrad", "reg_hypergrad", "KrylovInfo", "cg",
           "cg_batched", "diff_tv_denoise", "diff_denoise",
           "make_diff_denoise", "tgv_denoise_pdps", "tgv_energy",
           "tgv_implicit_cotangents", "diff_tgv_denoise",
           "make_diff_tgv_denoise", "TGV_PDPS_DEFAULTS", "tvl1_denoise",
           "tvl1_energy", "tvl1_huber_denoise", "tvl1_huber_energy",
           "tvl1_huber_hypergrad", "tvl1_huber_implicit_cotangents",
           "make_diff_tvl1_denoise", "diff_tvl1_denoise", "vtv_denoise",
           "vtv_implicit_cotangents", "diff_vtv_denoise",
           "make_diff_vtv_denoise"]
