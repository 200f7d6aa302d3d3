from .config import Params, merge

__all__ = ["Params", "merge"]
