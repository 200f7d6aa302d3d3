from .linop import LinOp, AdjointOp
from .grad import (FwdGradientOp, BwdGradientOp, CenteredGradientOp,
                   GradientOp)
from .field import xi, scalarprod, norm21, proj_norm21_ball

__all__ = [
    "LinOp", "AdjointOp",
    "FwdGradientOp", "BwdGradientOp", "CenteredGradientOp", "GradientOp",
    "xi", "scalarprod", "norm21", "proj_norm21_ball",
]
