"""Learning functions of the host trust region (counterpart of
``bpldenoising_tpu.learning``): each ``f(x, ds, Δ) → (u, cost, grad)`` and
its factory with warm-start caches."""

from .sumregs import make_sumregs_learning_function, sumregs_learning_function
from .tgv import make_tgv_learning_function, tgv_learning_function
from .tv import make_tv_learning_function, tv_learning_function
from .tvl1 import make_tvl1_learning_function, tvl1_learning_function
from .vtv import make_vtv_learning_function, vtv_learning_function

__all__ = ["tv_learning_function", "make_tv_learning_function",
           "sumregs_learning_function", "make_sumregs_learning_function",
           "tgv_learning_function", "make_tgv_learning_function",
           "vtv_learning_function", "make_vtv_learning_function",
           "tvl1_learning_function", "make_tvl1_learning_function"]
