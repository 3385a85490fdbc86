"""ResNetPL, the high-receptive-field perceptual loss every shipped LaMa
config uses at weight 30 (counterpart of lama_tpu/losses/perceptual.py:21-78;
reference perceptual.py:88-113).

Both images are ImageNet-normalised, run through the frozen ADE20k
ResNet50-dilated encoder in eval mode, and the MSE of each of its four stage
outputs (in float32) is summed. The weight is applied by the caller. The
encoder's weights load from a `.pth` when the path exists; otherwise, as in
the JAX package, it raises unless random weights are asked for
(`losses.resnet_pl.allow_random_weights=true`), which is for smoke runs
only: no weights exist in this repository.
"""
import logging
import os
from typing import Optional

import torch
import torch.nn as nn

from ..models.aux.resnet import ResNetDilatedEncoder
from ..models.aux.vgg import imagenet_normalize
from ..ops.precision import widen

LOGGER = logging.getLogger(__name__)


class ResNetPL(nn.Module):
    def __init__(self, weights_path: Optional[str] = None,
                 arch_encoder: str = 'resnet50dilated', dtype=torch.float32,
                 allow_random_weights: bool = False):
        """`weights_path`: the ADE20k encoder checkpoint, or the imagenet
        trunk's for the reference's segmentation=false ablations (the trunk
        is the same; the caller picks the file)."""
        super().__init__()
        assert arch_encoder in ('resnet50dilated', 'resnet50'), arch_encoder
        self.impl = ResNetDilatedEncoder(
            dilated=arch_encoder == 'resnet50dilated', dtype=dtype)
        if weights_path and os.path.exists(weights_path):
            state = torch.load(weights_path, map_location='cpu',
                               weights_only=False)
            if isinstance(state, dict) and 'state_dict' in state:
                state = state['state_dict']
            missing, _ = self.impl.load_state_dict(state, strict=False)
            LOGGER.info(f'ResNetPL weights loaded from {weights_path} '
                        f'({len(missing)} keys missing)')
        elif not allow_random_weights:
            raise FileNotFoundError(
                f'ResNetPL encoder weights not found at {weights_path!r}. '
                'Download the ADE20k resnet50dilated encoder or set '
                'losses.resnet_pl.allow_random_weights=true for smoke tests.')
        else:
            LOGGER.warning(f'ResNetPL weights not found at {weights_path!r}; '
                           'using RANDOM weights (explicitly allowed): loss '
                           'values will not match the reference.')
        self.impl.eval().requires_grad_(False)

    def train(self, mode=True):
        """The encoder is frozen: it stays in eval mode."""
        return self

    def forward(self, pred, target):
        pred_feats = self.impl(imagenet_normalize(pred))
        with torch.no_grad():
            target_feats = self.impl(imagenet_normalize(target))
        return torch.stack([(widen(p) - widen(t)).square().mean()
                            for p, t in zip(pred_feats, target_feats)]).sum()
