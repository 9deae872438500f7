"""Structural similarity (SSIM) in PyTorch (counterpart of
``multivae_tpu/ops/ssim.py``): Wang et al.'s formulation with an 11x11
Gaussian window of sigma 1.5, K1 = 0.01 and K2 = 0.03, the window applied
per channel without padding (a depthwise conv2d)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(preds, target, data_range: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5, reduce: bool = True) -> torch.Tensor:
    """Mean SSIM over a batch of (B, C, H, W) (or (B, H, W)) images.

    Args:
        preds / target: tensors of the same shape, channels first.
        data_range: dynamic range of the inputs.
        reduce: return the scalar batch mean (default); ``False`` returns
            the SSIM of each sample, (B,).
    """
    preds = torch.as_tensor(preds).float()
    target = torch.as_tensor(target).float().to(preds.device)
    if preds.ndim == 3:
        preds, target = preds[:, None], target[:, None]
    channels = preds.shape[1]
    kernel = torch.tensor(_gaussian_kernel(kernel_size, sigma), device=preds.device)
    kernel = kernel[None, None].expand(channels, 1, kernel_size, kernel_size)

    def filt(x):
        return F.conv2d(x, kernel, groups=channels)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x, mu_y = filt(preds), filt(target)
    sigma_x = filt(preds * preds) - mu_x**2
    sigma_y = filt(target * target) - mu_y**2
    sigma_xy = filt(preds * target) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    ssim_map = num / den
    if reduce:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
