from .quality import l2_cost, psnr, psnr_np, ssim, ssim_np

__all__ = ["psnr", "ssim", "l2_cost", "ssim_np", "psnr_np"]
