from .log import BilevelLogEntry, IterLog

__all__ = ["BilevelLogEntry", "IterLog"]
