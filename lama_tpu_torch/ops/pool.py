"""Pooling of NCHW tensors with the JAX package's semantics (counterpart of
lama_tpu/ops/conv.py:338-370 and the FID InceptionV3's 'same' pools,
lama_tpu/models/aux/inception.py:29-38).

The JAX pools reduce over 'VALID' windows (no padding, the last partial
window dropped), which is PyTorch's default floor mode. The 3x3 stride-1
'same' pools pad by one on each side: the average counts only the
in-bounds pixels (count_include_pad=False), the max pads with -inf, as
`F.max_pool2d(padding=1)` does.
"""
import torch.nn.functional as F


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def avg_pool2d(x, kernel_size=2, stride=None):
    kernel_size = _pair(kernel_size)
    stride = _pair(stride) if stride is not None else kernel_size
    return F.avg_pool2d(x, kernel_size, stride)


def max_pool2d(x, kernel_size=2, stride=None):
    kernel_size = _pair(kernel_size)
    stride = _pair(stride) if stride is not None else kernel_size
    return F.max_pool2d(x, kernel_size, stride)


def adaptive_avg_pool2d(x, output_size=(1, 1)):
    """Only the uniform cases the JAX version takes: global pooling, or
    output sizes that divide the input's. The global mean sums its window
    in another order than XLA's reduction, so the two can differ in the
    last bit."""
    oh, ow = _pair(output_size)
    h, w = x.shape[-2:]
    if h % oh or w % ow:
        raise ValueError('adaptive pool supports divisible sizes only')
    return avg_pool2d(x, (h // oh, w // ow))


def avg_pool_3x3_same_exclude_pad(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def max_pool_3x3_same(x):
    return F.max_pool2d(x, 3, 1, padding=1)
