"""Image quality metrics: PSNR, SSIM and the L2 cost (counterpart of
``bpldenoising_tpu.metrics.quality``).

Peak value 1.0 for [0, 1] float images; SSIM with the standard 11×11
Gaussian window (σ = 1.5), K = (0.01, 0.03), computed over the valid
(un-padded) window region as in the original Wang et al. implementation.
:func:`psnr` and :func:`ssim` run in the tensors' dtype on their device;
:func:`psnr_np` and :func:`ssim_np` are host float64, for report tables.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["psnr", "ssim", "l2_cost", "ssim_np", "psnr_np"]


def psnr_np(ref, img, peak: float = 1.0) -> float:
    """Host-side float64 PSNR for report tables."""
    ref = np.asarray(ref, dtype=np.float64)
    img = np.asarray(img, dtype=np.float64)
    mse = np.mean((ref - img) ** 2)
    return float(10.0 * np.log10(peak ** 2 / mse))


def ssim_np(ref, img, peak: float = 1.0, window_size: int = 11,
            sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> float:
    """Host-side float64 SSIM (scipy valid-window correlation); matches
    :func:`ssim` to ~1e-12 in float64."""
    from scipy.signal import correlate2d
    ref = np.asarray(ref, dtype=np.float64)
    img = np.asarray(img, dtype=np.float64)
    w = _gaussian_kernel(window_size, sigma)
    c1 = (k1 * peak) ** 2
    c2 = (k2 * peak) ** 2

    def filt(a):
        return correlate2d(a, w, mode="valid")

    mu1, mu2 = filt(ref), filt(img)
    s1 = np.maximum(filt(ref * ref) - mu1 ** 2, 0.0)
    s2 = np.maximum(filt(img * img) - mu2 ** 2, 0.0)
    s12 = filt(ref * img) - mu1 * mu2
    bound = np.sqrt(s1 * s2)
    s12 = np.clip(s12, -bound, bound)
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))
    return float(m.mean())


def l2_cost(u, utrue):
    """½‖u − ū‖² over the whole stack."""
    return 0.5 * torch.sum((torch.as_tensor(u) - torch.as_tensor(utrue)) ** 2)


def psnr(ref, img, peak: float = 1.0):
    """PSNR in dB of ``img`` against ``ref`` (per image, reduces the last
    two dims), in the tensors' dtype and on their device."""
    ref = torch.as_tensor(ref)
    img = torch.as_tensor(img)
    mse = torch.mean((ref - img) ** 2, dim=(-2, -1))
    return 10.0 * torch.log10(peak ** 2 / mse)


@functools.lru_cache(maxsize=None)
def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    """The normalised (size, size) Gaussian window, float64 (read-only)."""
    half = (size - 1) / 2.0
    x = np.arange(size) - half
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    w = np.outer(g, g)
    w.setflags(write=False)
    return w


def _filter2_valid(img, kernel):
    """2-D 'valid' correlation of (..., M, N) with a (w, w) kernel."""
    batch = tuple(img.shape[:-2])
    x = img.reshape((-1, 1) + tuple(img.shape[-2:]))
    k = torch.tensor(kernel, dtype=x.dtype, device=x.device)[None, None]
    out = F.conv2d(x, k)
    return out.reshape(batch + tuple(out.shape[-2:]))


def ssim(ref, img, peak: float = 1.0, window_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Mean SSIM index (per image, reduces the last two dims), in the
    tensors' dtype and on their device."""
    ref = torch.as_tensor(ref)
    img = torch.as_tensor(img, dtype=ref.dtype, device=ref.device)
    w = _gaussian_kernel(window_size, sigma)
    c1 = (k1 * peak) ** 2
    c2 = (k2 * peak) ** 2

    mu1 = _filter2_valid(ref, w)
    mu2 = _filter2_valid(img, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2_valid(ref * ref, w) - mu1_sq
    sigma2_sq = _filter2_valid(img * img, w) - mu2_sq
    sigma12 = _filter2_valid(ref * img, w) - mu12

    # E[x²] − μ² cancels catastrophically in float32 on near-flat windows,
    # giving negative variances and SSIM > 1; clamp to the feasible set
    # (σ² ≥ 0, |σ₁₂| ≤ σ₁σ₂) so the index stays in [−1, 1]
    sigma1_sq = torch.clamp(sigma1_sq, min=0.0)
    sigma2_sq = torch.clamp(sigma2_sq, min=0.0)
    bound = torch.sqrt(sigma1_sq * sigma2_sq)
    sigma12 = torch.maximum(torch.minimum(sigma12, bound), -bound)

    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map, dim=(-2, -1))
