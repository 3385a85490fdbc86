"""The VGG16 and VGG19 feature trunks in torchvision's layout, NCHW
(counterpart of lama_tpu/models/aux/vgg.py).

Used by LPIPS (vgg16 relu1_2 .. relu5_3; reference evaluation/losses/
lpips.py PNetLin), the VGG19 perceptual and style losses and the
perceptual-similarity distance weighting (VGG19). The trunk is an
`nn.Sequential` named `features` whose entries sit at torchvision's
indices (conv, ReLU, pool), so a torchvision state_dict's
`features.N.weight` / `features.N.bias` keys load with strict=True
(`load_trunk_weights`); a truncated trunk takes the keys it holds.
"""
import logging
import os
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ...ops.conv import Conv2d
from .random_init import seeded_random_init_

LOGGER = logging.getLogger(__name__)

VGG16_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
             512, 512, 512, 'M', 512, 512, 512, 'M']
VGG19_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
             512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M']

# torch sequential indices of the relu outputs LPIPS taps (vgg16):
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
VGG16_LPIPS_TAPS = (3, 8, 15, 22, 29)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(x):
    """[0, 1] RGB NCHW -> ImageNet-normalised (reference perceptual.py:10-11)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean[:, None, None]) / std[:, None, None]


class VGGFeatures(nn.Module):
    """Runs the `features` trunk of `cfg` and returns the activations after
    each layer index in `tap_indices` (torch sequential indices), as
    vgg.py:31-60: pools 'max' or 'avg' (the perceptual-loss variant), the
    trunk cut before index `stop_after`. The default is LPIPS's VGG16. Each
    conv runs in its input's dtype."""

    def __init__(self, cfg: Sequence = tuple(VGG16_CFG),
                 tap_indices: Sequence[int] = VGG16_LPIPS_TAPS,
                 pool: str = 'max', stop_after: Optional[int] = None):
        super().__init__()
        if pool not in ('max', 'avg'):
            raise ValueError(f'pool={pool!r}: expected max or avg')
        layers, in_ch = [], 3
        for v in cfg:
            if stop_after is not None and len(layers) >= stop_after:
                break
            if v == 'M':
                layers.append(nn.MaxPool2d(2, 2) if pool == 'max'
                              else nn.AvgPool2d(2, 2))
            else:
                layers += [Conv2d(in_ch, v, 3, padding=1), nn.ReLU()]
                in_ch = v
        self.features = nn.Sequential(*layers)
        self.tap_indices = tuple(tap_indices)

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.tap_indices:
                taps.append(x)
        return taps


def load_backbone_state(path: str):
    """A torchvision-format state_dict from a .pth/.pt file (its `state_dict`
    entry if it has one); the file is unpickled in full: load only trusted
    files."""
    state = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(state, dict) and 'state_dict' in state:
        state = state['state_dict']
    return state


def load_trunk_weights(model: nn.Module, path: Optional[str], what: str,
                       seed: int = 0) -> nn.Module:
    """A torchvision-format file's tensors that `model` holds (its
    `features.N.*`, for a trunk cut short too), loaded strictly; without a
    file at `path`, seeded random weights (models/aux/random_init.py) and
    a warning. The VGG trunks and LPIPS's AlexNet and SqueezeNet trunks
    load so."""
    if path and os.path.exists(path):
        state = load_backbone_state(path)
        own = model.state_dict()
        model.load_state_dict({k: v for k, v in state.items() if k in own},
                              strict=True)
        LOGGER.info(f'{what} weights loaded from {path}')
    else:
        seeded_random_init_(model, seed)
        LOGGER.warning(f'{what}: weights not found at {path!r}; using '
                       f'RANDOM weights (seed {seed}): its values will not '
                       'match the published network.')
    return model


def relu_taps(cfg=VGG19_CFG, stop_after=None, first_in_stage=False):
    """Torch sequential indices of the ReLU outputs of `cfg` before index
    `stop_after`: every one (lama_tpu/losses/perceptual.py:80-95, the
    perceptual loss) or, with `first_in_stage`, relu{1..5}_1
    (lama_tpu/losses/style.py:12-28, the style loss)."""
    taps, idx, first = [], 0, True
    for v in cfg:
        if stop_after is not None and idx >= stop_after:
            break
        if v == 'M':
            idx += 1
            first = True
            continue
        idx += 1   # the conv
        if (first or not first_in_stage) and (stop_after is None
                                             or idx < stop_after):
            taps.append(idx)
        first = False
        idx += 1   # the relu
    return tuple(taps)
