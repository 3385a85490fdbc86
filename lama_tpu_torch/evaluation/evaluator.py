"""Evaluator harness (counterpart of lama_tpu/evaluation/evaluator.py;
reference evaluation/evaluator.py), host code copied nearly line for line.

- `InpaintingEvaluator`: offline evaluation over (image, mask, inpainted)
  datasets with the mask-area breakdown in 10 bins.
- `InpaintingEvaluatorOnline`: the in-training variant, which keeps each
  batch's score states and merges them at `evaluation_end`.
- `ssim_fid100_f1` / `lpips_fid100_f1`: the integral checkpoint-selection
  metrics (reference evaluator.py:112-125).

Batches are NHWC numpy arrays in [0, 1]; each score moves them to its own
device.
"""
import logging
import math
from typing import Dict

import numpy as np

from ..data.datasets import BatchLoader

LOGGER = logging.getLogger(__name__)


def _interval_names(bins):
    num_digits = max(0, math.ceil(math.log10(bins)) - 1)
    bin_edges = np.linspace(0, 1, bins + 1)
    names = []
    for idx in range(bins):
        lo = '{:.{n}f}'.format(round(100 * bin_edges[idx], num_digits), n=num_digits)
        hi = '{:.{n}f}'.format(round(100 * bin_edges[idx + 1], num_digits), n=num_digits)
        names.append(f'{lo}-{hi}%')
    return bin_edges, names


def ssim_fid100_f1(metrics, fid_scale=100):
    ssim = metrics[('ssim', 'total')]['mean']
    fid = metrics[('fid', 'total')]['mean']
    fid_rel = max(0, fid_scale - fid) / fid_scale
    return 2 * ssim * fid_rel / (ssim + fid_rel + 1e-3)


def lpips_fid100_f1(metrics, fid_scale=100):
    neg_lpips = 1 - metrics[('lpips', 'total')]['mean']
    fid = metrics[('fid', 'total')]['mean']
    fid_rel = max(0, fid_scale - fid) / fid_scale
    return 2 * neg_lpips * fid_rel / (neg_lpips + fid_rel + 1e-3)


class InpaintingEvaluator:
    def __init__(self, dataset, scores, area_grouping=True, bins=10, batch_size=32,
                 integral_func=None, integral_title=None, clamp_image_range=None):
        self.dataset = dataset
        self.scores = scores
        self.area_grouping = area_grouping
        self.bins = bins
        self.batch_size = batch_size
        self.integral_func = integral_func
        self.integral_title = integral_title
        self.clamp_image_range = clamp_image_range

    def _loader(self):
        return BatchLoader(self.dataset, batch_size=self.batch_size, shuffle=False,
                           drop_last=False)

    def _get_bin_edges(self):
        bin_edges, interval_names = _interval_names(self.bins)
        groups = []
        for batch in self._loader():
            mask = batch['mask']
            area = mask.reshape(mask.shape[0], -1).mean(axis=-1)
            bin_indices = np.searchsorted(bin_edges, area, side='right') - 1
            bin_indices[bin_indices == self.bins] = self.bins - 1
            groups.append(bin_indices)
        return np.hstack(groups), interval_names

    def evaluate(self, model=None):
        """model: callable (image_batch, mask_batch) -> inpainted_batch (NHWC),
        or None to use the precomputed batch['inpainted']."""
        results = {}
        groups, interval_names = (None, None)
        if self.area_grouping:
            groups, interval_names = self._get_bin_edges()

        for score_name, score in self.scores.items():
            score.reset()
            for batch in self._loader():
                image_batch, mask_batch = batch['image'], batch['mask']
                if self.clamp_image_range is not None:
                    image_batch = np.clip(image_batch, *self.clamp_image_range)
                if model is None:
                    assert 'inpainted' in batch, \
                        'Model is None => expected precomputed "inpainted"'
                    inpainted_batch = batch['inpainted']
                else:
                    inpainted_batch = model(image_batch, mask_batch)
                score(inpainted_batch, image_batch, mask_batch)
            total_results, group_results = score.get_value(groups=groups)
            results[(score_name, 'total')] = total_results
            if groups is not None:
                for group_index, group_values in group_results.items():
                    results[(score_name, interval_names[group_index])] = group_values

        if self.integral_func is not None:
            results[(self.integral_title, 'total')] = dict(mean=self.integral_func(results))
        return results


class InpaintingEvaluatorOnline:
    """In-training evaluator: `process_batch` computes and keeps each
    batch's score states; `evaluation_end(states=...)` merges the states the
    caller collected into the keyed results (reference evaluator.py:
    129-220). A data-parallel trainer passes the states of every rank in
    rank order, having set `groups` to the ranks' bins in the same order."""

    def __init__(self, scores, bins=10, image_key='image', inpainted_key='inpainted',
                 integral_func=None, integral_title=None, clamp_image_range=None):
        self.scores = scores
        self.image_key = image_key
        self.inpainted_key = inpainted_key
        self.bins_num = bins
        self.bin_edges, self.interval_names = _interval_names(bins)
        self.groups = []
        self.integral_func = integral_func
        self.integral_title = integral_title
        self.clamp_image_range = clamp_image_range

    def _get_bins(self, mask_batch):
        area = np.asarray(mask_batch).reshape(mask_batch.shape[0], -1).mean(axis=-1)
        return np.clip(np.searchsorted(self.bin_edges, area) - 1, 0, self.bins_num - 1)

    def process_batch(self, batch: Dict) -> Dict:
        image_batch = batch[self.image_key]
        mask_batch = batch['mask']
        inpainted_batch = batch[self.inpainted_key]
        if self.clamp_image_range is not None:
            image_batch = np.clip(np.asarray(image_batch), *self.clamp_image_range)
        self.groups.extend(self._get_bins(mask_batch))
        return {name: score(inpainted_batch, image_batch, mask_batch)
                for name, score in self.scores.items()}

    def evaluation_end(self, states=None):
        groups = np.array(self.groups)
        results = {}
        for score_name, score in self.scores.items():
            cur_states = [s[score_name] for s in states] if states is not None else None
            total_results, group_results = score.get_value(groups=groups, states=cur_states)
            results[(score_name, 'total')] = total_results
            for group_index, group_values in (group_results or {}).items():
                results[(score_name, self.interval_names[group_index])] = group_values

        if self.integral_func is not None:
            results[(self.integral_title, 'total')] = dict(mean=self.integral_func(results))

        self.groups = []
        for sc in self.scores.values():
            sc.reset()
        return results
