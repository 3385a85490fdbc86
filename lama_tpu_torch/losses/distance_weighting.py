"""Mask distance weighting: the supervision mask reweighted by the distance
from the hole's boundary (counterpart of lama_tpu/losses/distance_weighting.py;
reference losses/distance_weighting.py:9-126), NCHW.

Kinds: none | blur (the gaussian-blurred mask, inside the hole) | edt
(dilate the known region, blur the rest) | pps (propagate "knownness" along
VGG19 level-2 feature similarity, `max_iters` steps). Each takes (real
image, prediction, mask) and returns a constant of the graph.
"""
import logging
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.aux.vgg import (VGG19_CFG, VGGFeatures, imagenet_normalize,
                              load_trunk_weights)
from ..ops.resize import interpolate

LOGGER = logging.getLogger(__name__)


def dummy_distance_weighter(real_img, pred_img, mask):
    return mask


def get_gauss_kernel(kernel_size, width_factor=1):
    """The reference's own gaussian (distance_weighting.py:22-29):
    exp(-sum((x - c)^2) / kernel_size / width_factor), normalised."""
    coords = np.stack(np.meshgrid(np.arange(kernel_size), np.arange(kernel_size),
                                  indexing='ij'), axis=0).astype(np.float64)
    diff = np.exp(-((coords - kernel_size // 2) ** 2).sum(0) / kernel_size
                  / width_factor)
    diff /= diff.sum()
    return diff.astype(np.float32)


def _conv_replicate(x, kernel2d):
    """A one-channel 2-D filter with replicate padding (:32-37)."""
    k = kernel2d.shape[0]
    kern = torch.as_tensor(kernel2d, dtype=x.dtype, device=x.device)
    return F.conv2d(F.pad(x, (k // 2,) * 4, mode='replicate'),
                    kern[None, None])


class BlurMask:
    def __init__(self, kernel_size=5, width_factor=1):
        self.kernel = get_gauss_kernel(kernel_size, width_factor)

    @torch.no_grad()
    def __call__(self, real_img, pred_img, mask):
        return _conv_replicate(mask, self.kernel) * mask


class EmulatedEDTMask:
    def __init__(self, dilate_kernel_size=5, blur_kernel_size=5, width_factor=1):
        self.dilate_kernel = np.ones((dilate_kernel_size, dilate_kernel_size),
                                     np.float32)
        self.blur_kernel = get_gauss_kernel(blur_kernel_size, width_factor)

    @torch.no_grad()
    def __call__(self, real_img, pred_img, mask):
        dilated_known = (_conv_replicate(1 - mask, self.dilate_kernel) > 1
                         ).to(mask.dtype)
        return _conv_replicate(1 - dilated_known, self.blur_kernel) * mask


class PropagatePerceptualSim(nn.Module):
    """Propagate knownness along VGG19 feature similarity (:60-113): the
    real image's level-`level` ReLU features (average pools) give a
    similarity to each vertical and horizontal neighbour; the known region
    (the mask resized to the features, thresholded after a replicate box
    filter of `erode_mask_size`) spreads `max_iters` times to each
    neighbour by that similarity; the result is min(mask, 1 - knownness).
    VGG weights: `vgg_weights_path` (a torchvision vgg19 file), else seeded
    random ones with a warning."""

    def __init__(self, level=2, max_iters=10, temperature=500, erode_mask_size=3,
                 vgg_weights_path: Optional[str] = None):
        super().__init__()
        idx = relus = 0
        for v in VGG19_CFG:
            if v == 'M':
                idx += 1
                continue
            idx += 2   # conv + relu
            relus += 1
            if relus == level:
                break
        self.model = load_trunk_weights(
            VGGFeatures(VGG19_CFG, (idx - 1,), pool='avg', stop_after=idx),
            vgg_weights_path, 'PropagatePerceptualSim')
        self.model.eval().requires_grad_(False)
        self.max_iters = max_iters
        self.temperature = temperature
        self.erode_mask_size = erode_mask_size

    def train(self, mode=True):
        """The trunk is frozen: it stays in eval mode."""
        return self

    @torch.no_grad()
    def forward(self, real_img, pred_img, mask):
        feats = self.model(imagenet_normalize(real_img))[0]
        vert_sim = torch.exp(-(feats[:, :, 1:] - feats[:, :, :-1]).square().sum(
            1, keepdim=True) / self.temperature)
        horz_sim = torch.exp(-(feats[:, :, :, 1:] - feats[:, :, :, :-1]).square()
                             .sum(1, keepdim=True) / self.temperature)
        mask_scaled = interpolate(mask, size=feats.shape[2:], mode='bilinear')
        if self.erode_mask_size > 0:
            k = np.ones((self.erode_mask_size, self.erode_mask_size), np.float32)
            mask_scaled = (_conv_replicate(mask_scaled, k) > 1).to(mask.dtype)
        cur = 1 - mask_scaled
        for _ in range(self.max_iters):
            top = F.pad(cur[:, :, :-1] * vert_sim, (0, 0, 1, 0), mode='replicate')
            bottom = F.pad(cur[:, :, 1:] * vert_sim, (0, 0, 0, 1),
                           mode='replicate')
            left = F.pad(cur[:, :, :, :-1] * horz_sim, (1, 0, 0, 0),
                         mode='replicate')
            right = F.pad(cur[:, :, :, 1:] * horz_sim, (0, 1, 0, 0),
                          mode='replicate')
            new = torch.maximum(torch.maximum(top, bottom),
                                torch.maximum(left, right))
            cur = torch.maximum(cur, new)
        knowness = interpolate(cur, size=mask.shape[2:], mode='bilinear')
        return torch.minimum(mask, 1 - knowness)


def make_mask_distance_weighter(kind='none', **kwargs):
    if kind == 'none':
        return dummy_distance_weighter
    if kind == 'blur':
        return BlurMask(**kwargs)
    if kind == 'edt':
        return EmulatedEDTMask(**kwargs)
    if kind == 'pps':
        return PropagatePerceptualSim(**kwargs)
    raise ValueError(f'Unknown mask distance weighter kind {kind}')
