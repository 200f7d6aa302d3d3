from .base import DenoiseModel
from ..ops import BwdGradientOp, CenteredGradientOp, FwdGradientOp


def tv_model() -> DenoiseModel:
    """Scalar TV denoising model (forward-difference gradient)."""
    return DenoiseModel(ops=(FwdGradientOp(),), name="tv")


def sumregs_model() -> DenoiseModel:
    """Sum-of-regularizers model with forward/backward/centered gradients."""
    return DenoiseModel(
        ops=(FwdGradientOp(), BwdGradientOp(), CenteredGradientOp()),
        name="sumregs")


__all__ = ["DenoiseModel", "tv_model", "sumregs_model"]
