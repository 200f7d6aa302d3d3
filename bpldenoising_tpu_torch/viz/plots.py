"""Cost-landscape plots (counterpart of ``bpldenoising_tpu.viz.plots``):
log-log 1-D cost curves and 2-D contour plots, written with matplotlib as
PNG and PDF (and ``.pgf`` where LaTeX is there).  matplotlib is imported
inside the functions, so the port runs without it until a plot is
asked for."""

from __future__ import annotations

import numpy as np

__all__ = ["plot_cost_curve", "plot_cost_contour"]


def _save_all(fig, base: str):
    fig.savefig(base + ".png", dpi=150, bbox_inches="tight")
    try:
        fig.savefig(base + ".pdf", bbox_inches="tight")
    except Exception:
        pass
    try:
        fig.savefig(base + ".pgf", bbox_inches="tight")
    except Exception:
        pass  # the pgf backend needs LaTeX; optional


def _pyplot():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_cost_curve(parameter_range, costs, base_path: str,
                    title: str = "Scalar Cost"):
    """Log-log α-against-cost curve, written to ``base_path`` + .png/.pdf."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.loglog(np.asarray(parameter_range), np.asarray(costs))
    ax.grid(True, which="both", alpha=0.4)
    ax.set_xlabel(r"$\alpha$")
    ax.set_ylabel(r"$\|u-\bar{u}\|^2$")
    ax.set_title(title)
    _save_all(fig, base_path)
    plt.close(fig)


def plot_cost_contour(range1, range2, costs, base_path: str,
                      title: str = "2D Cost", levels: int = 30):
    """Contour plot over (α₁, α₂), written to ``base_path`` + .png/.pdf."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    A1, A2 = np.meshgrid(np.asarray(range1), np.asarray(range2),
                         indexing="ij")
    cs = ax.contour(A1, A2, np.asarray(costs), levels=levels,
                    linestyles="dashed")
    ax.clabel(cs, inline=True, fontsize=6)
    ax.grid(True, alpha=0.4)
    ax.set_xlabel(r"$\alpha_1$")
    ax.set_ylabel(r"$\alpha_2$")
    ax.set_title(title)
    _save_all(fig, base_path)
    plt.close(fig)
