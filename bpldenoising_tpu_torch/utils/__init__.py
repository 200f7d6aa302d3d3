from .checkpoint import CheckpointWriter, load_checkpoint, save_checkpoint
from .config import Params, check_backend, merge
from .profiling import SectionTimer, trace

__all__ = ["Params", "merge", "check_backend",
           "save_checkpoint", "load_checkpoint", "CheckpointWriter",
           "trace", "SectionTimer"]
