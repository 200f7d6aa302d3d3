"""Bundled dataset registry and loader (counterpart of
``bpldenoising_tpu.data.datasets``).

(true, noisy) PNG pairs listed in a ``filelist.txt`` per dataset, with
prefix and Jaro–Winkler fuzzy name resolution.  ``datasets/`` resolves in
the repository checkout that holds this package (or ``$BPL_DATASETS``, or
the working directory).  Arrays are batch-first ``(O, M, N)`` float64 in
[0, 1], or planar ``(O, 3, M, N)`` with ``color=True``.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from .png_io import read_png_color, read_png_gray

__all__ = ["testdataset", "load_dataset", "full_datasetname",
           "remotedatasets", "dataset_dir"]

remotedatasets = [
    "cameraman_128_5",
    "cameraman_128_10",
    "faces_train_128_10",
    "faces_val_128_10",
    "circle_128_10",
    "pyramid_128_10",
    "color_disks_128_10",
    "circle_sp_128_20",
]


def _resolve_dataset_dir() -> str:
    """$BPL_DATASETS, then the repository checkout, then the CWD."""
    env = os.environ.get("BPL_DATASETS")
    if env:
        return env
    repo_root = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", ".."))
    candidate = os.path.join(repo_root, "datasets")
    if os.path.isdir(candidate):
        return candidate
    return os.path.join(os.getcwd(), "datasets")


dataset_dir = _resolve_dataset_dir()


def jaro_winkler(s1: str, s2: str, prefix_weight: float = 0.1) -> float:
    """Jaro–Winkler similarity in [0, 1] (reference: StringDistances.jl)."""
    if s1 == s2:
        return 1.0
    len1, len2 = len(s1), len(s2)
    if not len1 or not len2:
        return 0.0
    match_window = max(len1, len2) // 2 - 1
    match_window = max(match_window, 0)
    flags1 = [False] * len1
    flags2 = [False] * len2
    matches = 0
    for i, c in enumerate(s1):
        lo = max(0, i - match_window)
        hi = min(len2, i + match_window + 1)
        for j in range(lo, hi):
            if not flags2[j] and s2[j] == c:
                flags1[i] = flags2[j] = True
                matches += 1
                break
    if not matches:
        return 0.0
    transpositions = 0
    k = 0
    for i in range(len1):
        if flags1[i]:
            while not flags2[k]:
                k += 1
            if s1[i] != s2[k]:
                transpositions += 1
            k += 1
    transpositions //= 2
    jaro = (matches / len1 + matches / len2
            + (matches - transpositions) / matches) / 3.0
    prefix = 0
    for a, b in zip(s1, s2):
        if a != b or prefix == 4:
            break
        prefix += 1
    return jaro + prefix * prefix_weight * (1.0 - jaro)


def full_datasetname(name: str) -> str:
    """Resolve a (possibly partial) dataset name (ref ``src/Datasets.jl:27-48``):
    prefix match first, then the nearest fuzzy match with a warning, else an
    error listing similar candidates."""
    for ds in remotedatasets:
        if ds.startswith(name):
            return ds
    scores = [(jaro_winkler(name, ds), ds) for ds in remotedatasets]
    best_score, best = max(scores)
    msg = f'"{name}" not found in bpldenoising_tpu_torch.data.remotedatasets.'
    if best_score >= 0.8:
        warnings.warn(f'{msg} Load "{best}" instead.')
        return best
    similar = [ds for score, ds in scores if score >= 0.6]
    if similar:
        listing = "\n".join(f'  * "{s}"' for s in similar)
        msg += f" Do you mean one of the following?\n{listing}"
    raise ValueError(msg)


def load_dataset(path: str, color: bool = False):
    """Load (true, noisy) float64 stacks (O, M, N) from a dataset directory
    with a filelist.txt, or planar (O, 3, M, N) with ``color=True``
    (grayscale sources replicate their channel)."""
    read = read_png_color if color else read_png_gray
    filelist = os.path.join(path, "filelist.txt")
    with open(filelist) as fh:
        pairs = [line.strip().split(",") for line in fh if line.strip()]
    true_images, data_images = [], []
    for true_name, data_name in pairs:
        true_images.append(read(os.path.join(path, true_name)))
        data_images.append(read(os.path.join(path, data_name)))
    return np.stack(true_images), np.stack(data_images)


def testdataset(name: str, color: bool = False):
    """(true, noisy) image stacks for a registered dataset."""
    full = full_datasetname(name)
    return load_dataset(os.path.join(dataset_dir, full), color=color)
