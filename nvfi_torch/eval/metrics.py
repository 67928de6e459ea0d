"""Image quality metrics: MSE / PSNR / SSIM (numpy and scipy only).

The port's own copy of ``nvfi_tpu/eval/metrics.py``, with the same protocols:

* PSNR = 10 * log10(1 / mse) on [0,1] images.
* SSIM: 11-tap Gaussian window (sigma 1.5), per-image mean, VALID padding.
* LPIPS is not ported (ROADMAP.md A11: no calibrated VGG weights are at
  hand): ``lpips_available`` is False and ``estim_error`` reports three
  metrics.
"""

from __future__ import annotations

import math
import os

import numpy as np


def mse(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2))


def mse2psnr(v: float) -> float:
    """Scalar convenience."""
    if v == 0:
        v = 1e-5
    return -10.0 * math.log10(v)


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    return 10.0 * math.log10(1.0 / max(mse(pred, gt), 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def ssim(pred: np.ndarray, gt: np.ndarray, w_size: int = 11) -> float:
    """Gaussian-window SSIM on a single (H, W, C) image pair in [0, 1]."""
    from scipy.signal import convolve2d

    img0 = np.asarray(pred, dtype=np.float64)
    img1 = np.asarray(gt, dtype=np.float64)
    if img0.ndim == 2:
        img0, img1 = img0[..., None], img1[..., None]
    filt = _gaussian_kernel(w_size)

    def blur(z):
        return np.stack(
            [
                convolve2d(convolve2d(z[..., c], filt[:, None], mode="valid"), filt[None, :],
                           mode="valid")
                for c in range(z.shape[-1])
            ],
            axis=-1,
        )

    mu0, mu1 = blur(img0), blur(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = np.maximum(blur(img0 * img0) - mu00, 0)
    s11 = np.maximum(blur(img1 * img1) - mu11, 0)
    s01 = blur(img0 * img1) - mu01
    s01 = np.sign(s01) * np.minimum(np.sqrt(s00 * s11), np.abs(s01))
    c1, c2 = 0.01**2, 0.03**2
    num = (2 * mu01 + c1) * (2 * s01 + c2)
    den = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    return float(np.mean(num / den))


def lpips_available() -> bool:
    """False: LPIPS is not ported (ROADMAP.md A11)."""
    return False


def estim_error(estim: np.ndarray, gt: np.ndarray) -> dict:
    """Batch metric dict over (N, H, W, 3) stacks."""
    estim = np.asarray(estim, dtype=np.float32)
    gt = np.asarray(gt, dtype=np.float32)
    return {
        "mse": mse(estim, gt),
        "psnr": psnr(estim, gt),
        "ssim": float(np.mean([ssim(estim[i], gt[i]) for i in range(len(estim))])),
    }


def save_error(errors: dict, save_dir: str, ext: str = ""):
    with open(os.path.join(save_dir, f"metrics{ext}.txt"), "w") as f:
        f.write(str(errors))
