"""Pixel and feature-matching losses (counterpart of
lama_tpu/losses/feature_matching.py; reference losses/feature_matching.py:7-33),
NCHW."""
from typing import List, Optional

import torch

from ..ops.resize import interpolate


def masked_l1_loss(pred, target, mask, weight_known, weight_missing):
    per_pixel = (pred - target).abs()
    weights = mask * weight_missing + (1 - mask) * weight_known
    return (weights * per_pixel).mean()


def feature_matching_loss(fake_features: List, target_features: List,
                          mask: Optional[torch.Tensor] = None):
    """Mean over stages of the MSE between features; with a mask, the
    known region only (the mask bilinearly resized to each stage)."""
    if mask is None:
        return torch.stack([(f - t).square().mean() for f, t in
                            zip(fake_features, target_features)]).mean()
    res = 0.0
    for f, t in zip(fake_features, target_features):
        cur_mask = interpolate(mask, size=f.shape[2:], mode='bilinear',
                               align_corners=False)
        res = res + ((f - t).square() * (1 - cur_mask)).mean()
    return res / len(fake_features)
