"""Resizing of NCHW tensors with torch's F.interpolate semantics
(counterpart of lama_tpu/ops/resize.py, which reimplements them for NHWC):
bilinear with half-pixel centres and no anti-aliasing, and nearest with
src = floor(dst * in / out). The refiner uses bilinear only."""
import torch.nn.functional as F

from .precision import widen

_MODES = ('bilinear', 'nearest')


def interpolate(x, size=None, scale_factor=None, mode='bilinear',
                align_corners=False):
    """Resize H and W of an NCHW tensor; bilinear computes in float32
    (float64 for a float64 input) and returns `x`'s dtype, as the JAX
    version does."""
    if mode not in _MODES:
        raise NotImplementedError(f'interpolate mode={mode!r} is not ported '
                                  'yet (ROADMAP queue 1 item 2)')
    if mode == 'nearest':
        return F.interpolate(x, size=size, scale_factor=scale_factor,
                             mode='nearest')
    return F.interpolate(widen(x), size=size, scale_factor=scale_factor,
                         mode='bilinear', align_corners=align_corners,
                         antialias=False).to(x.dtype)
