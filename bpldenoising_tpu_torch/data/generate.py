"""Dataset synthesis: build loader-compatible (true, noisy) PNG datasets
(counterpart of ``bpldenoising_tpu.data.generate``).

* :func:`circle_phantom`, :func:`affine_phantom`, :func:`color_phantom`:
  piecewise-constant and piecewise-affine test images.
* :func:`add_noise` (Gaussian, clipped to [0, 1]) and
  :func:`add_impulse_noise` (salt and pepper).
* :func:`make_dataset`: write ``<name>_true_<i>.png`` /
  ``<name>_data_<i>.png`` pairs and ``filelist.txt`` in the layout
  :func:`.datasets.load_dataset` reads, and register the name so
  ``testdataset(name)`` resolves it.

Host-side numpy only.  Every random draw comes from
``np.random.default_rng``, so a seed gives the JAX package's bits.
"""

from __future__ import annotations

import os

import numpy as np

from . import datasets as _registry
from .png_io import write_png_color, write_png_gray

__all__ = ["circle_phantom", "affine_phantom", "color_phantom", "add_noise",
           "add_impulse_noise", "make_dataset"]


def circle_phantom(size: int = 128, radius: float = 0.3,
                   center=(0.5, 0.5), intensity: float = 1.0) -> np.ndarray:
    """Binary disk on a black background (float64 (size, size) in [0, 1]),
    matching the reference's bundled circle images (1-bit disk,
    ``datasets/circle_128_10``/``images/circle_128_orig.png``)."""
    if size <= 0:
        raise ValueError(f"size must be positive, got {size}")
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = (center[0] * (size - 1), center[1] * (size - 1))
    r2 = (yy - cy) ** 2 + (xx - cx) ** 2
    return np.where(r2 <= (radius * size) ** 2, float(intensity), 0.0)


def affine_phantom(size: int = 128, kind: str = "pyramid",
                   seed: int | None = None) -> np.ndarray:
    """Piecewise-AFFINE phantom (float64 (size, size) in [0, 1]) — the
    image class TGV² reconstructs exactly where TV staircases
    (Bredies–Kunisch–Pock 2010; :mod:`..solvers.tgv`), complementing the
    piecewise-constant :func:`circle_phantom` that favors TV.

    kinds: ``"ramp"`` (single linear gradient), ``"pyramid"`` (ℓ∞ cone —
    four affine facets with gradient discontinuities), ``"facets"``
    (random continuous piecewise-affine surface: the max of several random
    planes, rescaled; ``seed`` selects the planes)."""
    if size <= 0:
        raise ValueError(f"size must be positive, got {size}")
    yy, xx = np.mgrid[0:size, 0:size] / max(size - 1, 1)
    if kind == "ramp":
        return xx.astype(np.float64)
    if kind == "pyramid":
        return (1.0 - 2.0 * np.maximum(np.abs(yy - 0.5),
                                       np.abs(xx - 0.5))).astype(np.float64)
    if kind == "facets":
        rng = np.random.default_rng(0 if seed is None else seed)
        planes = [rng.uniform(-1, 1) * (yy - rng.uniform(0, 1))
                  + rng.uniform(-1, 1) * (xx - rng.uniform(0, 1))
                  for _ in range(5)]
        z = np.maximum.reduce(planes)
        lo, hi = z.min(), z.max()
        return ((z - lo) / max(hi - lo, 1e-12)).astype(np.float64)
    raise ValueError(f"unknown affine phantom kind {kind!r}")


def color_phantom(size: int = 128, kind: str = "disks",
                  seed: int | None = None) -> np.ndarray:
    """Piecewise-constant COLOR phantom (planar float64 (3, size, size) in
    [0, 1]) — the home-turf image class of the channel-coupled vectorial
    TV model (:func:`..models.vtv_model`): object edges are shared by all
    three channels, which is exactly the structure the coupled Frobenius
    regularizer exploits over per-channel TV.

    kinds: ``"disks"`` (saturated RGB disks on a gray background, pairwise
    overlaps mixing channels), ``"squares"`` (random axis-aligned colored
    rectangles, ``seed`` selects them)."""
    if size <= 0:
        raise ValueError(f"size must be positive, got {size}")
    yy, xx = np.mgrid[0:size, 0:size] / max(size - 1, 1)
    img = np.full((3, size, size), 0.35, np.float64)
    if kind == "disks":
        centers = [(0.38, 0.36), (0.40, 0.64), (0.68, 0.50)]
        colors = [(0.95, 0.15, 0.12), (0.12, 0.85, 0.20),
                  (0.10, 0.25, 0.95)]
        for (cy, cx), col in zip(centers, colors):
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= 0.22 ** 2
            for c in range(3):
                img[c] = np.where(mask, col[c], img[c])
        return img
    if kind == "squares":
        rng = np.random.default_rng(0 if seed is None else seed)
        for _ in range(6):
            y0, x0 = rng.uniform(0.05, 0.6, 2)
            h, w = rng.uniform(0.15, 0.35, 2)
            col = rng.uniform(0.0, 1.0, 3)
            mask = ((yy >= y0) & (yy < y0 + h)
                    & (xx >= x0) & (xx < x0 + w))
            for c in range(3):
                img[c] = np.where(mask, col[c], img[c])
        return img
    raise ValueError(f"unknown color phantom kind {kind!r}")


def add_noise(img: np.ndarray, sigma: float,
              rng: np.random.Generator | int | None = 0) -> np.ndarray:
    """``img + N(0, sigma²)`` clipped to [0, 1].  ``sigma`` is in absolute
    units of the [0, 1] range (the reference's ``_10`` suffix ⇒ 0.10)."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    noisy = np.asarray(img, np.float64) + rng.normal(0.0, sigma, img.shape)
    return np.clip(noisy, 0.0, 1.0)


def add_impulse_noise(img: np.ndarray, density: float,
                      rng: np.random.Generator | int | None = 0
                      ) -> np.ndarray:
    """Salt-and-pepper noise: a ``density`` fraction of pixels is replaced
    by 0 or 1 (equal probability).  The noise model matched by the TV-L1
    data term (:mod:`..solvers.tvl1`) rather than the reference's
    Gaussian/L2 pairing."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    img = np.asarray(img, np.float64)
    hit = rng.uniform(size=img.shape) < density
    salt = rng.uniform(size=img.shape) < 0.5
    return np.where(hit, np.where(salt, 1.0, 0.0), img)


def make_dataset(name: str, true_images, sigma: float = 0.1,
                 seed: int = 0, out_root: str | None = None,
                 noisy_images=None, register: bool = True) -> str:
    """Write a loadable dataset and return its directory.

    Parameters
    ----------
    name: dataset directory name (reference convention:
        ``<base>_<size>_<noisepct>``).
    true_images: iterable of 2-D arrays in [0, 1] (or one (O, M, N) stack).
    sigma: Gaussian noise std for the data images (ignored when
        ``noisy_images`` is given explicitly).
    seed: RNG seed for the noise (one stream across the whole set, so the
        dataset is reproducible from (images, sigma, seed)).
    out_root: parent directory (default: the loader's ``dataset_dir``).
    noisy_images: optional pre-made data images (same layout as
        ``true_images``) for externally-degraded pairs.
    register: also append ``name`` to ``remotedatasets`` so
        ``testdataset(name)`` (prefix/fuzzy resolution included) finds it
        in this process.
    """
    true_list = [np.asarray(t, np.float64) for t in true_images]
    if not true_list:
        raise ValueError("true_images is empty")
    color = true_list[0].ndim == 3
    for t in true_list:
        if color:
            if t.ndim != 3 or t.shape[0] != 3:
                raise ValueError(f"color images must be planar (3, M, N), "
                                 f"got shape {t.shape}")
        elif t.ndim != 2:
            raise ValueError(f"true images must be 2-D (or all planar "
                             f"(3, M, N) for a color dataset), got shape "
                             f"{t.shape}")
        if t.min() < 0.0 or t.max() > 1.0:
            raise ValueError("true images must lie in [0, 1]")
    if noisy_images is not None:
        noisy_list = [np.asarray(d, np.float64) for d in noisy_images]
        if len(noisy_list) != len(true_list):
            raise ValueError(
                f"{len(true_list)} true images but {len(noisy_list)} noisy")
        for t, d in zip(true_list, noisy_list):
            if d.shape != t.shape:
                raise ValueError(
                    f"pair shape mismatch: {t.shape} vs {d.shape}")
    else:
        rng = np.random.default_rng(seed)
        noisy_list = [add_noise(t, sigma, rng) for t in true_list]

    root = out_root if out_root is not None else _registry.dataset_dir
    out_dir = os.path.join(root, name)
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    write = write_png_color if color else write_png_gray
    for i, (t, d) in enumerate(zip(true_list, noisy_list), start=1):
        tn, dn = f"{name}_true_{i}.png", f"{name}_data_{i}.png"
        write(os.path.join(out_dir, tn), t)
        write(os.path.join(out_dir, dn), d)
        lines.append(f"{tn},{dn}")
    with open(os.path.join(out_dir, "filelist.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")

    if register and name not in _registry.remotedatasets:
        # only meaningful when the dataset lands inside dataset_dir, where
        # testdataset() resolves names
        if os.path.realpath(root) == os.path.realpath(_registry.dataset_dir):
            _registry.remotedatasets.append(name)
    return out_dir
