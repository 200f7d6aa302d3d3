"""Image quality metrics: PSNR and the L2 cost (counterpart of
``bpldenoising_tpu.metrics.quality``; SSIM is not ported yet)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["psnr", "psnr_np", "l2_cost"]


def psnr_np(ref, img, peak: float = 1.0) -> float:
    """Host-side float64 PSNR for report tables."""
    ref = np.asarray(ref, dtype=np.float64)
    img = np.asarray(img, dtype=np.float64)
    mse = np.mean((ref - img) ** 2)
    return float(10.0 * np.log10(peak ** 2 / mse))


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
