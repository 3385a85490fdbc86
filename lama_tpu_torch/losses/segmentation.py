"""Weighted 2-D cross entropy of the ADE20k segmentation-guided ablations
(counterpart of lama_tpu/losses/segmentation.py; reference
losses/segmentation.py:8-43), NCHW logits as the reference takes them."""
from typing import Optional

import torch

from .constants import weights as constant_weights


def cross_entropy_2d(predict, target, weights: Optional[str] = None,
                     ignore_label: int = 255, reduction: str = 'mean'):
    """predict: (N, C, H, W) logits; target: (N, H, W) or (N, 1, H, W) int
    labels. Pixels labelled < 0 or ignore_label are excluded; with class
    `weights` ('ade20k') the mean divides by the weighted count of the
    valid pixels. The log-softmax is taken in float32."""
    if target.dim() == 4:
        target = target[:, 0]
    target = target.long()
    valid = (target >= 0) & (target != ignore_label)
    safe_target = torch.where(valid, target, torch.zeros_like(target))

    log_probs = torch.log_softmax(predict.float(), dim=1)
    loss = -log_probs.gather(1, safe_target[:, None])[:, 0]

    if weights is not None:
        w = torch.tensor(constant_weights[weights], dtype=torch.float32,
                         device=loss.device)
        pixel_w = w[safe_target]
        loss = loss * pixel_w
        denom = torch.sum(pixel_w * valid)
    else:
        denom = torch.sum(valid)

    loss = loss * valid
    if reduction == 'mean':
        return torch.sum(loss) / denom.float().clamp(min=1e-8)
    if reduction == 'sum':
        return torch.sum(loss)
    return loss


class CrossEntropy2d:
    def __init__(self, reduction='mean', ignore_label=255, weights=None, **kwargs):
        self.reduction = reduction
        self.ignore_label = ignore_label
        self.weights = weights

    def __call__(self, predict, target):
        return cross_entropy_2d(predict, target, weights=self.weights,
                                ignore_label=self.ignore_label,
                                reduction=self.reduction)
