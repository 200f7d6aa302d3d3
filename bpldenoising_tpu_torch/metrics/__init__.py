from .quality import l2_cost, psnr, psnr_np

__all__ = ["psnr", "psnr_np", "l2_cost"]
