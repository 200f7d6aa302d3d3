from .log import BilevelLogEntry, IterLog, write_log
from .plots import plot_cost_contour, plot_cost_curve

__all__ = ["BilevelLogEntry", "IterLog", "write_log",
           "plot_cost_curve", "plot_cost_contour"]
