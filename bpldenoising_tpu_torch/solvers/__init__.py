from .hypergrad import HypergradConfig, exact_hypergrad, reg_hypergrad
from .krylov import KrylovInfo, cg, cg_batched
from .pdps import (PDPS_DEFAULTS, denoise_pdps, sumregs_denoise, tv_denoise,
                   vtv_denoise)
from .tgv import (TGV_PDPS_DEFAULTS, tgv_denoise_pdps, tgv_energy,
                  tgv_implicit_cotangents)
from .tvl1 import tvl1_denoise, tvl1_energy
from .tvl1_huber import (tvl1_huber_denoise, tvl1_huber_energy,
                         tvl1_huber_hypergrad)
from .vtv import vtv_implicit_cotangents

__all__ = ["denoise_pdps", "tv_denoise", "sumregs_denoise", "PDPS_DEFAULTS", "HypergradConfig",
           "exact_hypergrad", "reg_hypergrad", "KrylovInfo", "cg",
           "cg_batched", "tgv_denoise_pdps", "tgv_energy",
           "tgv_implicit_cotangents", "TGV_PDPS_DEFAULTS", "tvl1_denoise",
           "tvl1_energy", "tvl1_huber_denoise", "tvl1_huber_energy",
           "tvl1_huber_hypergrad", "vtv_denoise", "vtv_implicit_cotangents"]
