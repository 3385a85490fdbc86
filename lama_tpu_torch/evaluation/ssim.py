"""Windowed gaussian SSIM of NCHW images (counterpart of
lama_tpu/evaluation/ssim.py; reference evaluation/losses/ssim.py:6-74).

An 11x11 gaussian window with sigma 1.5, a depthwise conv per channel
with zero 'same' padding, C1 = 0.01^2, C2 = 0.03^2, and one mean per
image. The variance is E[x^2] - mu^2, which cancels on flat windows, so
the filter runs in true float32: the JAX package runs it at
Precision.HIGHEST (ssim.py:33-40), and on the card the scores turn TF32
off (`utils.no_tf32`). The window is the outer product of a 1-D gaussian,
so the filter runs as two 1-D depthwise passes of 11 taps (zero padding
is separable too). The 2-D depthwise conv of oneDNN, PyTorch's CPU
backend, lost up to 3.4e-6 of a 64^2 image's SSIM against a float64
SSIM; the two passes stay within 2e-7, as the JAX one does.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..ops.precision import widen


def gaussian_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The 1-D gaussian whose outer product is lama_tpu's 2-D window
    (ssim.py:14-20)."""
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5,
         size_average: bool = False):
    """img1, img2: NCHW in [0, 1]. Per-image SSIM (B,), or its mean."""
    img1, img2 = widen(img1), widen(img2)
    c = img1.shape[1]
    g = torch.from_numpy(gaussian_1d(window_size, sigma)).to(img1.device,
                                                              img1.dtype)
    rows = g.view(1, 1, window_size, 1).expand(c, 1, window_size, 1)
    cols = g.view(1, 1, 1, window_size).expand(c, 1, 1, window_size)
    pad = window_size // 2

    def filt(x):
        x = F.conv2d(x, rows, padding=(pad, 0), groups=c)
        return F.conv2d(x, cols, padding=(0, pad), groups=c)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(img1 * img1) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / \
               ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
