"""LPIPS (net-lin) of NCHW images (counterpart of
lama_tpu/evaluation/lpips.py; reference evaluation/losses/lpips.py:
PerceptualLoss -> DistModel -> PNetLin with NetLinLayer 1x1 heads).

[0, 1] -> [-1, 1], then the LPIPS shift and scale, the backbone's taps
(vgg16 relu1_2 .. relu5_3, or the AlexNet / SqueezeNet taps), each tap
unit-normalised over channels (eps 1e-10), the squared difference, the
tap's 1x1 head (|w|, no bias), the spatial mean, and the sum over taps.

The heads are richzhang's released ones, carried in
lama_tpu_torch/resources/lpips_lin/{vgg,alex,squeeze}.npz (byte copies of
the JAX package's). The backbone loads a torchvision state_dict when its
path exists; otherwise it takes seeded random weights
(models/aux/random_init.py) and logs a warning: no backbone weights are in
this repository.
"""
import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.aux.small_nets import (ALEXNET_TAP_CHANNELS, AlexNetFeatures,
                                     SQUEEZE_TAP_CHANNELS, SqueezeNetFeatures)
from ..models.aux.vgg import (VGGFeatures, load_backbone_state,
                              load_trunk_weights)

# richzhang ScalingLayer constants (lpips.py PNetLin)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
VGG16_TAP_CHANNELS = (64, 128, 256, 512, 512)
_LPIPS_LIN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'resources', 'lpips_lin')


def default_lin_weights_path(net: str) -> str:
    return os.path.join(_LPIPS_LIN_DIR, f'{net}.npz')


def normalize_tensor(x, eps=1e-10):
    """Unit norm over the channel axis (dim 1)."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    def __init__(self, net: str = 'vgg', backbone_weights_path: Optional[str] = None,
                 lin_weights_path: Optional[str] = None, seed: int = 0):
        super().__init__()
        self.net = net
        if net == 'vgg':
            self.model = VGGFeatures()
            tap_channels = VGG16_TAP_CHANNELS
        elif net == 'alex':
            self.model = AlexNetFeatures()
            tap_channels = ALEXNET_TAP_CHANNELS
        elif net == 'squeeze':
            self.model = SqueezeNetFeatures()
            tap_channels = SQUEEZE_TAP_CHANNELS
        else:
            raise ValueError(f'Unknown LPIPS net {net}')
        load_trunk_weights(self.model, backbone_weights_path,
                           f'LPIPS {net} backbone', seed)
        path = lin_weights_path or default_lin_weights_path(net)
        if path.endswith('.npz'):
            state = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
        else:
            state = load_backbone_state(path)
        for i in range(len(tap_channels)):   # (1, C, 1, 1) each
            self.register_buffer(f'lin{i}', torch.as_tensor(
                state[f'lin{i}.model.1.weight'], dtype=torch.float32).clone())
        self.register_buffer('shift', torch.tensor(_SHIFT)[None, :, None, None])
        self.register_buffer('scale', torch.tensor(_SCALE)[None, :, None, None])
        self.eval().requires_grad_(False)

    def features(self, x):
        x = 2 * x.float() - 1
        return self.model((x - self.shift) / self.scale)

    def forward(self, pred, target):
        """NCHW [0, 1] images -> per-image LPIPS distance (B,)."""
        total = 0.0
        for i, (fp, ft) in enumerate(zip(self.features(pred),
                                         self.features(target))):
            diff = (normalize_tensor(fp.float())
                    - normalize_tensor(ft.float())).square()
            w = getattr(self, f'lin{i}').abs()
            total = total + (diff * w).sum(dim=1).mean(dim=(1, 2))
        return total
