"""Visualization of inputs and prediction maps.

Equivalent of the reference's DDA visualization helpers
(model/DDA_model/utils/visualization.py:13-126): quick-look plots of
optical/SAR composites, built-up probabilities and population maps.

Counterpart of popcorn_tpu/utils/viz.py, with the time series' totals
plot (``save_totals_plot``). matplotlib is imported inside the functions
that draw, so the module imports without it and a caller without it gets
ImportError from the call.
"""

from __future__ import annotations

import numpy as np


def _ax(ax):
    if ax is None:
        import matplotlib.pyplot as plt

        _, ax = plt.subplots(figsize=(6, 6))
    return ax


def plot_optical(s2_rgb: np.ndarray, ax=None, scale_factor: float = 0.4 / 4000):
    """True-colour S2 quicklook; input (H,W,>=3) raw reflectance [R,G,B...]."""
    ax = _ax(ax)
    img = np.clip(s2_rgb[..., :3].astype(np.float32) * scale_factor * 10, 0, 1)
    ax.imshow(img)
    ax.set_axis_off()
    return ax


def plot_sar(s1_vv: np.ndarray, ax=None, vmin: float = -25, vmax: float = 0):
    """Grey SAR backscatter quicklook (dB)."""
    ax = _ax(ax)
    ax.imshow(np.clip(s1_vv, vmin, vmax), cmap="gray", vmin=vmin, vmax=vmax)
    ax.set_axis_off()
    return ax


def plot_probability(prob: np.ndarray, ax=None):
    ax = _ax(ax)
    im = ax.imshow(prob, cmap="viridis", vmin=0, vmax=1)
    ax.set_axis_off()
    return ax


def plot_population(dense: np.ndarray, ax=None, q: float = 99.0):
    """Population-density map with robust upper bound."""
    ax = _ax(ax)
    vmax = np.percentile(dense[dense > 0], q) if (dense > 0).any() else 1.0
    ax.imshow(dense, cmap="magma", vmin=0, vmax=max(vmax, 1e-6))
    ax.set_axis_off()
    return ax


def _headless_pyplot():
    """matplotlib's pyplot on the Agg backend, for figures saved to files."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_quicklook(path: str, s2=None, s1=None, builtup=None, pop=None):
    """Multi-panel quicklook figure for a sample or a region."""
    plt = _headless_pyplot()
    panels = [(n, a) for n, a in
              [("S2", s2), ("S1 VV", s1), ("built-up", builtup), ("population", pop)]
              if a is not None]
    fig, axs = plt.subplots(1, len(panels), figsize=(5 * len(panels), 5))
    if len(panels) == 1:
        axs = [axs]
    for ax, (name, arr) in zip(axs, panels):
        if name == "S2":
            plot_optical(arr, ax)
        elif name == "S1 VV":
            plot_sar(arr, ax)
        elif name == "built-up":
            plot_probability(arr, ax)
        else:
            plot_population(arr, ax)
        ax.set_title(name)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def save_totals_plot(path: str, records) -> str:
    """The population time series' totals with their ensemble std as error
    bars, one point a time step (``records``: the label, total_population
    and total_std of each step, in time order)."""
    plt = _headless_pyplot()

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.errorbar([r["label"] for r in records], [r["total_population"] for r in records],
                yerr=[r["total_std"] for r in records], marker="o")
    ax.set_ylabel("total population")
    ax.set_xlabel("time step")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
