"""Spatial padding of NCHW tensors with torch's mode names (counterpart of
lama_tpu/ops/pad.py): 'reflect' (no edge repeat: row -1 is row 1),
'replicate', and 'zeros'/'zero'/'constant'."""
import torch.nn.functional as F

_MODES = {'reflect': 'reflect', 'replicate': 'replicate', 'zeros': 'constant',
          'zero': 'constant', 'constant': 'constant'}


def pad2d(x, padding, mode='zeros'):
    """Pad H and W of an NCHW tensor. padding: int, (pad_h, pad_w) or
    ((top, bottom), (left, right))."""
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    elif isinstance(padding[0], int):
        padding = ((padding[0], padding[0]), (padding[1], padding[1]))
    (top, bottom), (left, right) = padding
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), mode=_MODES[mode])
