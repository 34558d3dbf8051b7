from trident.ai.model import InterpolationUNet
from trident.ai.metrics import psnr, ssim

__all__ = ["InterpolationUNet", "psnr", "ssim"]
