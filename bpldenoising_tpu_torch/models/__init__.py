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


def vtv_model() -> DenoiseModel:
    """Vectorial (color) TV: the per-pixel Frobenius norm over the stacked
    channel gradients ‖(∇u)_pix‖_F, so channels couple through the dual
    projection; the same forward-difference gradient as ``tv_model``."""
    return DenoiseModel(ops=(FwdGradientOp(),), channels=True, name="vtv")


__all__ = ["DenoiseModel", "tv_model", "sumregs_model", "vtv_model"]
