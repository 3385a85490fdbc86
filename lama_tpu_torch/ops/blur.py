"""Separable gaussian blur of NCHW tensors (counterpart of
lama_tpu/ops/blur.py:15-41; the kornia/OpenCV kernel, symmetric and
normalised)."""
import numpy as np
import torch
import torch.nn.functional as F

def gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    ax = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    k = np.exp(-0.5 * (ax / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur2d(x, kernel_size, sigma, border_type='reflect'):
    """Depthwise blur along H, then W; kernel_size and sigma per (h, w) or
    one for both; border_type: reflect, replicate or constant (F.pad's)."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size, kernel_size)
    if isinstance(sigma, (int, float)):
        sigma = (float(sigma), float(sigma))
    c = x.shape[1]
    ph, pw = kernel_size[0] // 2, kernel_size[1] // 2
    kh = torch.from_numpy(gaussian_kernel1d(kernel_size[0], sigma[0]))
    kw = torch.from_numpy(gaussian_kernel1d(kernel_size[1], sigma[1]))
    kh = kh.to(x.device, x.dtype).view(1, 1, -1, 1).repeat(c, 1, 1, 1)
    kw = kw.to(x.device, x.dtype).view(1, 1, 1, -1).repeat(c, 1, 1, 1)
    x = F.pad(x, (pw, pw, ph, ph), mode=border_type)
    return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)
