from .config import Params, check_backend, merge

__all__ = ["Params", "merge", "check_backend"]
