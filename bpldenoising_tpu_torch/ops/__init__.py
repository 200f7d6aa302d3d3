from .linop import LinOp, AdjointOp, ZeroOp, IdentityOp
from .grad import (FwdGradientOp, BwdGradientOp, CenteredGradientOp,
                   GradientOp)
from .field import xi, scalarprod, norm21, proj_norm21_ball
from .patch import PatchOp
from .tgv import SymGradientOp, sym_grad, sym_div, TGV_OPNORM_SQ

__all__ = [
    "LinOp", "AdjointOp", "ZeroOp", "IdentityOp",
    "FwdGradientOp", "BwdGradientOp", "CenteredGradientOp", "GradientOp",
    "xi", "scalarprod", "norm21", "proj_norm21_ball", "PatchOp",
    "SymGradientOp", "sym_grad", "sym_div", "TGV_OPNORM_SQ",
]
