from .api import (
    L2CostFunction,
    TVDenoise,
    bilevel_params,
    default_params,
    generate_2d_cost_plot,
    generate_2d_tv_cost,
    generate_cost_plot,
    generate_scalar_tv_cost,
    patch_bilevel_params,
    patch_bilevel_sumregs_learn,
    patch_bilevel_tv_learn,
    patch_sumregs_bilevel_params,
    save_results,
    scalar_bilevel_sumregs_learn,
    scalar_bilevel_tv_learn,
    sumregs_bilevel_params,
    validate_sumregs_parameter,
    validate_tv_parameter,
)

__all__ = [
    "TVDenoise", "L2CostFunction",
    "generate_scalar_tv_cost", "generate_cost_plot",
    "generate_2d_tv_cost", "generate_2d_cost_plot",
    "scalar_bilevel_tv_learn", "patch_bilevel_tv_learn",
    "scalar_bilevel_sumregs_learn", "patch_bilevel_sumregs_learn",
    "validate_tv_parameter", "validate_sumregs_parameter",
    "save_results", "default_params", "bilevel_params",
    "patch_bilevel_params", "sumregs_bilevel_params",
    "patch_sumregs_bilevel_params",
]

from .tgv import (TGVDenoise, generate_tgv_cost, generate_tgv_cost_plot,
                  patch_bilevel_tgv_learn, patch_tgv_bilevel_params,
                  scalar_bilevel_tgv_learn, tgv_bilevel_params,
                  validate_tgv_parameter)
__all__ += ["TGVDenoise", "scalar_bilevel_tgv_learn",
            "patch_bilevel_tgv_learn", "tgv_bilevel_params",
            "patch_tgv_bilevel_params", "validate_tgv_parameter",
            "generate_tgv_cost", "generate_tgv_cost_plot"]

from .vtv import (VTVDenoise, generate_vtv_cost, generate_vtv_cost_plot,
                  patch_bilevel_vtv_learn, patch_vtv_bilevel_params,
                  scalar_bilevel_vtv_learn, validate_vtv_parameter,
                  vtv_bilevel_params)
__all__ += ["VTVDenoise", "scalar_bilevel_vtv_learn",
            "patch_bilevel_vtv_learn", "vtv_bilevel_params",
            "patch_vtv_bilevel_params", "validate_vtv_parameter",
            "generate_vtv_cost", "generate_vtv_cost_plot"]

from .tvl1 import (TVL1Denoise, generate_tvl1_cost, generate_tvl1_cost_plot,
                   patch_bilevel_tvl1_learn, patch_tvl1_bilevel_params,
                   scalar_bilevel_tvl1_learn, tvl1_bilevel_params,
                   tvl1_params, validate_tvl1_parameter)
__all__ += ["TVL1Denoise", "validate_tvl1_parameter", "tvl1_params",
            "generate_tvl1_cost", "generate_tvl1_cost_plot",
            "scalar_bilevel_tvl1_learn", "patch_bilevel_tvl1_learn",
            "tvl1_bilevel_params", "patch_tvl1_bilevel_params"]
