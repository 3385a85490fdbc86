"""ResNetPL, the high-receptive-field perceptual loss every shipped LaMa
config uses at weight 30 (counterpart of lama_tpu/losses/perceptual.py:21-78;
reference perceptual.py:88-113), and the classic VGG19 perceptual loss
(lama_tpu/losses/perceptual.py:100-143; reference perceptual.py:14-85),
which the ablv2_work_no_segmpl_vgg configs train with at weight 0.03.

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
from ..models.aux.vgg import (VGG19_CFG, VGGFeatures, imagenet_normalize,
                              load_trunk_weights, relu_taps)
from ..ops.precision import widen
from ..ops.resize import interpolate

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


class VGG19PerceptualLoss(nn.Module):
    """The VGG19 trunk up to index 30 with average pools, frozen; for each
    ReLU it taps, the squared difference of the two images' features in
    float32, times 1 - the mask (bilinearly resized to the tap) when a mask
    is given, averaged per sample. Returns the per-sample vector, the sum
    over taps; the caller sums it over the batch and weighs it
    (lama_tpu/training/step.py:178-181). Weights: a torchvision vgg19 file
    at `weights_path` (the trainer passes $LAMA_VGG19_WEIGHTS, as
    lama_tpu's trainer.py:102-106), else seeded random ones with a warning.
    The trunk runs in `dtype`."""

    def __init__(self, weights_path: Optional[str] = None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.model = load_trunk_weights(
            VGGFeatures(VGG19_CFG, relu_taps(VGG19_CFG, 30), pool='avg',
                        stop_after=30), weights_path, 'VGG19PerceptualLoss')
        self.model.eval().requires_grad_(False)

    def train(self, mode=True):
        """The trunk is frozen: it stays in eval mode."""
        return self

    def partial_losses(self, input, target, mask=None):
        input, target = imagenet_normalize(input), imagenet_normalize(target)
        feats_in = self.model(input.to(self.dtype))
        with torch.no_grad():
            feats_tg = self.model(target.to(self.dtype))
        losses = []
        for fi, ft in zip(feats_in, feats_tg):
            loss = (widen(fi) - widen(ft)).square()
            if mask is not None:
                loss = loss * (1 - interpolate(mask, size=fi.shape[2:],
                                               mode='bilinear'))
            losses.append(loss.mean(dim=(1, 2, 3)))
        return losses

    def forward(self, input, target, mask=None):
        return torch.stack(self.partial_losses(input, target, mask)).sum(0)
