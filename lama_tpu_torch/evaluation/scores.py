"""Score accumulators (counterpart of lama_tpu/evaluation/scores.py;
reference evaluation/losses/base_loss.py:92-218).

Each score takes NHWC batches in [0, 1] (numpy, as the loaders give them),
moves them to its device as NCHW float32, computes per-image values (or
InceptionV3 activations) there under `no_tf32`, and keeps them on the host.
`__call__` returns the batch's state, which the online evaluator collects
(`states` in `get_value`).
"""
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .fid import InceptionActivations, calculate_frechet_distance
from .lpips import LPIPS
from .ssim import ssim
from .utils import no_tf32

LOGGER = logging.getLogger(__name__)


def get_groupings(groups):
    """{group index: array of sample indices} (reference base_loss.py:22-34)."""
    label_groups, count_groups = np.unique(groups, return_counts=True)
    indices = np.argsort(groups)
    grouping = {}
    cur_start = 0
    for label, count in zip(label_groups, count_groups):
        cur_end = cur_start + count
        grouping[label] = indices[cur_start:cur_end]
        cur_start = cur_end
    return grouping


def to_device_nchw(batch, device) -> torch.Tensor:
    """NHWC numpy batch -> NCHW float32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(
        device).permute(0, 3, 1, 2)


class PairwiseScore:
    def __init__(self, device='cuda'):
        self.device = torch.device(device)
        self.individual_values: Optional[np.ndarray] = None
        self.reset()

    def reset(self):
        self.individual_values = np.array([], dtype=np.float64)

    def get_value(self, groups=None, states=None) -> Tuple[Dict, Optional[Dict]]:
        individual_values = np.concatenate([np.asarray(s) for s in states]) \
            if states is not None else self.individual_values
        total_results = {
            'mean': float(individual_values.mean()),
            'std': float(individual_values.std()),
        }
        if groups is None:
            group_results = None
        else:
            group_results = {}
            grouping = get_groupings(groups)
            for label, index in grouping.items():
                group_scores = individual_values[index]
                group_results[label] = {'mean': float(group_scores.mean()),
                                        'std': float(group_scores.std())}
        self.reset()
        return total_results, group_results

    def values(self, pred, target) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def __call__(self, pred_batch, target_batch, mask=None):
        with no_tf32():
            batch_values = self.values(to_device_nchw(pred_batch, self.device),
                                       to_device_nchw(target_batch, self.device))
        batch_values = batch_values.double().cpu().numpy().ravel()
        self.individual_values = np.hstack([self.individual_values, batch_values])
        return batch_values


class SSIMScore(PairwiseScore):
    def __init__(self, window_size=11, device='cuda'):
        self.window_size = window_size
        super().__init__(device)

    def values(self, pred, target):
        return ssim(pred, target, window_size=self.window_size,
                    size_average=False)


class LPIPSScore(PairwiseScore):
    def __init__(self, model='net-lin', net='vgg', model_path=None,
                 vgg_weights_path=None, lin_weights_path=None, device='cuda'):
        if (model, net) != ('net-lin', 'vgg'):
            raise ValueError(f'LPIPSScore takes model=net-lin, net=vgg, not '
                             f'{model}, {net}')
        super().__init__(device)
        self.lpips = LPIPS(
            net=net,
            backbone_weights_path=vgg_weights_path
            or os.environ.get('LAMA_LPIPS_VGG_WEIGHTS'),
            lin_weights_path=lin_weights_path or model_path
            or os.environ.get('LAMA_LPIPS_LIN_WEIGHTS')).to(self.device)

    def values(self, pred, target):
        return self.lpips(pred, target)


class FIDScore:
    """Accumulates pred / target InceptionV3 activations; the Frechet
    distance on the host at get_value (total and per group; reference
    base_loss.py:155-218)."""

    def __init__(self, dims=2048, eps=1e-6, weights_path=None, device='cuda'):
        if dims != 2048:
            raise ValueError(f'FIDScore takes the 2048-d pool, not dims={dims}')
        self.model = InceptionActivations.get(device=device,
                                              weights_path=weights_path)
        self.eps = eps
        self.reset()

    def reset(self):
        self.activations_pred: List[np.ndarray] = []
        self.activations_target: List[np.ndarray] = []

    def __call__(self, pred_batch, target_batch, mask=None):
        device = self.model.device
        act_pred = self.model.activations(
            to_device_nchw(pred_batch, device)).cpu().numpy()
        act_target = self.model.activations(
            to_device_nchw(target_batch, device)).cpu().numpy()
        self.activations_pred.append(act_pred)
        self.activations_target.append(act_target)
        return act_pred, act_target

    def get_value(self, groups=None, states=None):
        if states is not None:
            pairs = list(states)
            activations_pred = np.concatenate([np.asarray(p) for p, _ in pairs])
            activations_target = np.concatenate([np.asarray(t) for _, t in pairs])
        else:
            activations_pred = np.concatenate(self.activations_pred)
            activations_target = np.concatenate(self.activations_target)

        def frechet(a, b):
            mu1, sigma1 = a.mean(axis=0), np.cov(a, rowvar=False)
            mu2, sigma2 = b.mean(axis=0), np.cov(b, rowvar=False)
            return float(calculate_frechet_distance(mu1, sigma1, mu2, sigma2,
                                                    eps=self.eps))

        total_results = {'mean': frechet(activations_pred, activations_target)}
        if groups is None:
            group_results = None
        else:
            group_results = {}
            for label, index in get_groupings(groups).items():
                if len(index) > 1:
                    group_results[label] = {
                        'mean': frechet(activations_pred[index],
                                        activations_target[index])}
                else:
                    group_results[label] = {'mean': float('nan')}
        self.reset()
        return total_results, group_results
