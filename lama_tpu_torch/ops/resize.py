"""Resizing of NCHW tensors with torch's F.interpolate semantics
(counterpart of lama_tpu/ops/resize.py, which reimplements them for NHWC):
bilinear with half-pixel centres and no anti-aliasing, nearest with src =
floor(dst * in / out), and lama_tpu's `area` (resize.py:70-83).

`area` is lama_tpu's, not F.interpolate's: a shrink by integer factors on
both axes is an average pool (other factors raise, as lama_tpu asserts);
when either axis grows, the whole resize is jax.image.resize(...,
'linear') (`resize_linear`): a triangle filter of half-pixel centres on
every axis whose size changes, anti-aliased (widened by the factor) on an
axis that shrinks. So a mixed resize (one axis shrinks, one grows)
filters the shrinking axis with that widened triangle, not with a pool,
and matches lama_tpu (tests/test_torch_ffc_options.py). F.interpolate's
`area` replicates pixels when it grows; it is not used."""
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .pool import avg_pool2d
from .precision import widen

_MODES = ('bilinear', 'nearest', 'area')


def _out_size(shape, size=None, scale_factor=None):
    """(oh, ow) of lama_tpu's `_out_size` (resize.py:14-20):
    int(side * factor) for a scale factor."""
    if size is not None:
        return (size, size) if isinstance(size, int) else tuple(size)
    sf = (scale_factor if isinstance(scale_factor, (tuple, list))
          else (scale_factor, scale_factor))
    return int(shape[-2] * sf[0]), int(shape[-1] * sf[1])


def interpolate(x, size=None, scale_factor=None, mode='bilinear',
                align_corners=False):
    """Resize H and W of an NCHW tensor to `size` or int(side *
    scale_factor); bilinear and a growing area compute in float32 (float64
    for a float64 input) and return `x`'s dtype, as the JAX version
    does."""
    if mode not in _MODES:
        raise ValueError(f'unsupported interpolate mode {mode}')
    oh, ow = _out_size(x.shape, size, scale_factor)
    if mode == 'nearest':
        return F.interpolate(x, size=(oh, ow), mode='nearest')
    if mode == 'area':
        h, w = x.shape[-2:]
        if oh > h or ow > w:
            return resize_linear(x, (oh, ow))
        if h % oh or w % ow:
            raise ValueError(f'area resize supports integer factors: '
                             f'{h}x{w} -> {oh}x{ow}')
        return avg_pool2d(x, (h // oh, w // ow))
    return F.interpolate(widen(x), size=(oh, ow), mode='bilinear',
                         align_corners=align_corners,
                         antialias=False).to(x.dtype)


def linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of jax.image.resize's 'linear' method along
    one axis (jax/_src/image/scale.py::compute_weight_mat, antialias on,
    no translation), float64: a triangle at the half-pixel sample point,
    widened by n_in / n_out when shrinking, each column normalised to sum
    1."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(n_in)[:, None])
    wgt = np.maximum(0.0, 1.0 - dist / max(inv_scale, 1.0))
    total = wgt.sum(axis=0, keepdims=True)
    wgt = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                   wgt / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], wgt, 0.0)


def resize_linear(x, size):
    """jax.image.resize(x, ..., 'linear') over H and W of an NCHW tensor:
    each axis whose size changes contracted with its `linear_weights`, in
    float32 (float64 for a float64 input); returns x's dtype."""
    y = widen(x)
    for dim, n_out in ((-2, size[0]), (-1, size[1])):
        n_in = y.shape[dim]
        if n_in == n_out:
            continue
        y = torch.movedim(torch.movedim(y, dim, -1)
                          @ _weight_tensor(n_in, n_out, y.device, y.dtype),
                          -1, dim)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _weight_tensor(n_in, n_out, device, dtype):
    """`linear_weights` on the device, kept: a FourierUnit resizes back at
    every call, and a copy from the host each time would pace the card.
    Made outside inference mode, so a later training forward can save it
    for its backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(linear_weights(n_in, n_out)).to(device, dtype)
