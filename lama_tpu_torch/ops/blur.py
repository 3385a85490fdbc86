"""Separable gaussian blur of NCHW tensors (counterpart of
lama_tpu/ops/blur.py:15-41; the kornia/OpenCV kernel, symmetric and
normalised), and flat-kernel erosion and dilation (blur.py:44-59)."""
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


def _window(x, kernel_size: int, fill: float, take_min: bool):
    """The min or max over each kernel_size^2 window of x padded by
    kernel_size // 2 with `fill` on every side (lama_tpu's 'VALID'
    reduce_window after a constant pad)."""
    p = kernel_size // 2
    xp = F.pad(x, (p, p, p, p), mode='constant', value=fill)
    if take_min:
        return -F.max_pool2d(-xp, kernel_size, stride=1)
    return F.max_pool2d(xp, kernel_size, stride=1)


def erosion(x, kernel_size: int):
    """Greyscale erosion of NCHW x with an all-ones square structuring
    element: the minimum over each window, the border padded with +inf
    (kornia.morphology.erosion for a flat kernel)."""
    return _window(x, kernel_size, float('inf'), True)


def dilation(x, kernel_size: int):
    """Greyscale dilation: the maximum over each window, the border padded
    with -inf."""
    return _window(x, kernel_size, float('-inf'), False)
