"""ADE20k semantic segmentation (counterpart of
lama_tpu/models/aux/segmentation.py; reference models/ade20k/base.py:
ModelBuilder, SegmentationModule, PPMDeepsup, C1DeepSup): the
resnet50dilated encoder with the PPM-deepsup decoder, or the
mobilenetv2dilated encoder with the C1-deepsup decoder, 150 classes, NCHW.

Keys follow the reference's (`ppm.{i}.1`, `ppm.{i}.2`, `conv_last.0`,
`.1`, `.4` for PPM; `cbr.0`, `.1` and `conv_last` for C1), so the ADE20k
`{encoder,decoder}_epoch_20.pth` files load; their deep-supervision heads
(`*deepsup*`, used only in training) are dropped. Without both files the
module takes seeded He-scaled random weights (models/aux/random_init.py)
and logs a warning: its labels then compare only with themselves.
"""
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...evaluation.utils import no_tf32
from ...ops.conv import Conv2d
from ...ops.norm import BatchNorm2d
from ...ops.resize import interpolate
from .mobilenet import MobileNetV2DilatedEncoder
from .random_init import seeded_random_init_
from .resnet import ResNetDilatedEncoder
from .vgg import imagenet_normalize

LOGGER = logging.getLogger(__name__)

NUM_CLASS = 150


def _class_scores(x, seg_size):
    """Inference upsamples the logits and takes the softmax; otherwise the
    log-softmax. Both in float32 (reference base.py:339-343)."""
    if seg_size is not None:
        x = interpolate(x, size=tuple(seg_size), mode='bilinear',
                        align_corners=False)
        return torch.softmax(x.float(), dim=1)
    return torch.log_softmax(x.float(), dim=1)


class PPMDeepsup(nn.Module):
    """Pyramid pooling decoder (reference base.py:290-345) on the encoder's
    last map. torch's adaptive pool bins are the JAX version's
    (adaptive_avg_pool2d_torch). The reference's dropout (p=0.1, index 3
    of conv_last) is inactive at inference and left out."""

    def __init__(self, num_class=NUM_CLASS, fc_dim=2048,
                 pool_scales: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.ppm = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(scale),
                          Conv2d(fc_dim, 512, 1, bias=False),
                          BatchNorm2d(512), nn.ReLU())
            for scale in pool_scales)
        self.conv_last = nn.Sequential(
            Conv2d(fc_dim + len(pool_scales) * 512, 512, 3, padding=1,
                   bias=False),
            BatchNorm2d(512), nn.ReLU(), nn.Identity(),
            Conv2d(512, num_class, 1))

    def forward(self, conv_out: List[torch.Tensor], seg_size=None):
        conv5 = conv_out[-1]
        size = tuple(conv5.shape[2:])
        ppm_out = [conv5] + [interpolate(m(conv5), size=size, mode='bilinear',
                                         align_corners=False)
                             for m in self.ppm]
        return _class_scores(self.conv_last(torch.cat(ppm_out, dim=1)),
                             seg_size)


class C1DeepSup(nn.Module):
    """Last-conv decoder (reference base.py:515-552), paired with the
    mobilenetv2dilated encoder (fc_dim 320)."""

    def __init__(self, num_class=NUM_CLASS, fc_dim=320):
        super().__init__()
        self.cbr = nn.Sequential(
            Conv2d(fc_dim, fc_dim // 4, 3, padding=1, bias=False),
            BatchNorm2d(fc_dim // 4), nn.ReLU())
        self.conv_last = Conv2d(fc_dim // 4, num_class, 1)

    def forward(self, conv_out: List[torch.Tensor], seg_size=None):
        return _class_scores(self.conv_last(self.cbr(conv_out[-1])), seg_size)


class SegmentationModuleNet(nn.Module):
    """Encoder + decoder, the reference ModelBuilder's pairs
    (base.py:166-173)."""

    def __init__(self, arch_encoder: str = 'resnet50dilated'):
        super().__init__()
        if arch_encoder == 'resnet50dilated':
            self.encoder = ResNetDilatedEncoder()
            self.decoder = PPMDeepsup()
        elif arch_encoder == 'mobilenetv2dilated':
            self.encoder = MobileNetV2DilatedEncoder()
            self.decoder = C1DeepSup(fc_dim=320)
        else:
            raise NotImplementedError(f'No such arch_encoder={arch_encoder}')

    def forward(self, x, seg_size=None, return_feature_maps=False):
        fmaps = self.encoder(x)
        if return_feature_maps:
            return fmaps
        return self.decoder(fmaps, seg_size=seg_size)


def resolve_ade20k_weight_paths(weights_path: Optional[str],
                                arch_encoder: str = 'resnet50dilated'):
    """The (encoder, decoder) .pth pair under a TORCH_HOME-style root, or
    (None, None) unless both files exist (a copy of lama_tpu's rule,
    segmentation.py:152-173: a partial download would mix real and random
    weights). The layout is `ade20k/ade20k-{arch}-ppm_deepsup/` for both
    encoders, as lama_tpu's."""
    if not weights_path:
        return None, None
    enc = weights_path if weights_path.endswith('.pth') else os.path.join(
        weights_path, 'ade20k', f'ade20k-{arch_encoder}-ppm_deepsup',
        'encoder_epoch_20.pth')
    dec = enc.replace('encoder_', 'decoder_')
    if not (os.path.exists(enc) and os.path.exists(dec)):
        if os.path.exists(enc) != os.path.exists(dec):
            LOGGER.warning(
                f'Partial ADE20k weights: only one of {enc} / {dec} exists; '
                'ignoring both (encoder and decoder must be fetched together)')
        return None, None
    return enc, dec


def load_reference_state(module: nn.Module, state: Dict[str, torch.Tensor]):
    """Load a reference-layout state_dict into `module`: the `*deepsup*`
    entries are dropped, every other key must match. A BatchNorm's
    `num_batches_tracked`, which files from older PyTorch lack and which
    eval mode never reads, keeps the module's value when absent."""
    state = {k: v for k, v in state.items() if 'deepsup' not in k}
    own = module.state_dict()
    missing = [k for k in own if k not in state
               and not k.endswith('num_batches_tracked')]
    unexpected = [k for k in state if k not in own]
    if missing or unexpected:
        raise KeyError(f'ADE20k state_dict: missing {missing[:8]}, '
                       f'unexpected {unexpected[:8]}')
    module.load_state_dict({**own, **state}, strict=True)


class SegmentationModule:
    """The frozen segmenter on `device` (reference base.py:147-287): [0, 1]
    RGB in, ImageNet-normalised, per-pixel ADE20k labels out. Weights: the
    ADE20k pair under `weights_path` (a TORCH_HOME-style root), else
    `state_dict` (the port's keys), else seeded random weights (seed 0)
    with a warning. Runs in float32 with TF32 off."""

    def __init__(self, weights_path: Optional[str] = None,
                 arch_encoder: str = 'resnet50dilated', device='cuda',
                 state_dict=None):
        self.device = torch.device(device)
        self.net = SegmentationModuleNet(arch_encoder)
        enc, dec = resolve_ade20k_weight_paths(weights_path, arch_encoder)
        if enc is not None:
            for part, path in (('encoder', enc), ('decoder', dec)):
                load_reference_state(getattr(self.net, part), torch.load(
                    path, map_location='cpu', weights_only=True))
            LOGGER.info(f'ADE20k {arch_encoder} weights loaded from {enc}')
        elif state_dict is not None:
            self.net.load_state_dict(state_dict, strict=True)
        else:
            seeded_random_init_(self.net, 0)
            LOGGER.warning('SegmentationModule weights unavailable '
                           f'({weights_path}); RANDOM weights (seed 0): '
                           'segmentation outputs are only self-consistent.')
        self.net.to(self.device).eval().requires_grad_(False)

    def _input(self, images) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(
            self.device).permute(0, 3, 1, 2)
        return imagenet_normalize(x)

    @torch.no_grad()
    def predict(self, images, seg_size=None) -> Tuple[np.ndarray, torch.Tensor]:
        """images: NHWC [0, 1] numpy. Returns the label map (B, H, W) int64
        on the host and the class scores (B, 150, H, W) float32 on the
        device."""
        seg_size = tuple(seg_size) if seg_size is not None else images.shape[1:3]
        with no_tf32():
            scores = self.net(self._input(images), seg_size=seg_size)
        return scores.argmax(dim=1).cpu().numpy(), scores

    @torch.no_grad()
    def get_feature_maps(self, images) -> List[torch.Tensor]:
        with no_tf32():
            return self.net(self._input(images), return_feature_maps=True)
