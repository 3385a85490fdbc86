"""Segmentation-aware scores (counterpart of
lama_tpu/evaluation/segm_scores.py; reference evaluation/losses/
base_loss.py:221-528): SSIM, LPIPS and FID attributed to the ADE20k classes
inside the mask, and the class frequency statistics.

The segmenter (models/aux/segmentation.py) and the score nets run on
`device`; the bincounts, the per-class sums and the Frechet distances are
host numpy, copied from lama_tpu. The FID's per-class attribution takes a
leave-one-out FID per image: lama_tpu runs those in parallel with joblib,
which the port does not depend on, so here they run in a pool of spawned
processes (concurrent.futures), in lama_tpu's order. The
FID of all images is computed once and serves as both the 'mean' and the
leave-one-out baseline (lama_tpu computes it twice): N + 1 host sqrtm of
2048^2 per group of N images.
"""
import contextlib
import csv
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict

import numpy as np
import torch

from .fid import InceptionActivations, calculate_frechet_distance
from .scores import LPIPSScore, SSIMScore, get_groupings, to_device_nchw
from .utils import no_tf32

NUM_CLASS = 150
_RESOURCES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          'resources')


def get_segmentation_idx2name() -> Dict[int, str]:
    """0-based class index -> name, from object150_info.csv (reference
    base_loss.py:268-270 reads the same table)."""
    idx2name = {}
    with open(os.path.join(_RESOURCES, 'object150_info.csv')) as f:
        for row in csv.DictReader(f):
            idx2name[int(row['Idx']) - 1] = row['Name']
    return idx2name


def distribute_values_to_classes(target_class_freq_by_image_mask, values, idx2name):
    """Weight per-image values by per-class pixel frequencies inside the mask
    (reference base_loss.py:262-268)."""
    assert target_class_freq_by_image_mask.ndim == 2
    assert target_class_freq_by_image_mask.shape[0] == values.shape[0]
    total_class_freq = target_class_freq_by_image_mask.sum(0)
    distr_values = (target_class_freq_by_image_mask * values[..., None]).sum(0)
    result = distr_values / (total_class_freq + 1e-3)
    return {idx2name[i]: val for i, val in enumerate(result) if total_class_freq[i] > 0}


class SegmentationAwareScore:
    """Accumulates per-image class pixel frequencies (total and in-mask for
    the target, in-mask for the prediction) from the segmenter's labels.
    `segm_network` is anything with `predict(nhwc) -> (labels, scores)`,
    such as an ADE20k SegmentationModule on `device`, which
    evaluate_predicts shares among the segm scores."""

    def __init__(self, segm_network, device='cuda'):
        self.device = torch.device(device)
        self.segm_network = segm_network
        self.reset()

    def reset(self):
        self.target_class_freq_by_image_total = []
        self.target_class_freq_by_image_mask = []
        self.pred_class_freq_by_image_mask = []

    def __call__(self, pred_batch, target_batch, mask):
        pred_segm = np.asarray(self.segm_network.predict(pred_batch)[0]
                               ).reshape(pred_batch.shape[0], -1)
        target_segm = np.asarray(self.segm_network.predict(target_batch)[0]
                                 ).reshape(pred_batch.shape[0], -1)
        mask_flat = np.asarray(mask).reshape(mask.shape[0], -1) > 0.5

        batch_total, batch_mask, batch_pred = [], [], []
        for p, t, m in zip(pred_segm, target_segm, mask_flat):
            batch_total.append(np.bincount(t, minlength=NUM_CLASS)[None])
            batch_mask.append(np.bincount(t[m], minlength=NUM_CLASS)[None])
            batch_pred.append(np.bincount(p[m], minlength=NUM_CLASS)[None])
        self.target_class_freq_by_image_total += batch_total
        self.target_class_freq_by_image_mask += batch_mask
        self.pred_class_freq_by_image_mask += batch_pred
        return (np.concatenate(batch_total), np.concatenate(batch_mask),
                np.concatenate(batch_pred))


class SegmentationAwarePairwiseScore(SegmentationAwareScore):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.segm_idx2name = get_segmentation_idx2name()
        self.individual_values = []

    def reset(self):
        super().reset()
        self.individual_values = []

    def calc_score(self, pred_batch, target_batch, mask):
        raise NotImplementedError

    def __call__(self, pred_batch, target_batch, mask):
        cur_class_stats = super().__call__(pred_batch, target_batch, mask)
        score_values = self.calc_score(pred_batch, target_batch, mask)
        self.individual_values.append(score_values)
        return cur_class_stats + (score_values,)

    def _collect(self, states):
        if states is not None:
            totals, masks, preds, values = (list(t) for t in zip(*states))
        else:
            totals = self.target_class_freq_by_image_total
            masks = self.target_class_freq_by_image_mask
            preds = self.pred_class_freq_by_image_mask
            values = self.individual_values
        return (np.concatenate(totals, axis=0), np.concatenate(masks, axis=0),
                np.concatenate(preds, axis=0), values)

    def get_value(self, groups=None, states=None):
        totals, masks, preds, values = self._collect(states)
        individual_values = np.concatenate(values, axis=0)
        total_results = {
            'mean': individual_values.mean(),
            'std': individual_values.std(),
            **distribute_values_to_classes(masks, individual_values, self.segm_idx2name),
        }
        if groups is None:
            self.reset()
            return total_results, None
        group_results = {}
        for label, index in get_groupings(groups).items():
            group_scores = individual_values[index]
            group_results[label] = {
                'mean': group_scores.mean(),
                'std': group_scores.std(),
                **distribute_values_to_classes(masks[index], group_scores,
                                               self.segm_idx2name),
            }
        self.reset()
        return total_results, group_results


class SegmentationClassStats(SegmentationAwarePairwiseScore):
    """Class frequency statistics (reference base_loss.py:340-437)."""

    def calc_score(self, pred_batch, target_batch, mask):
        return np.zeros(pred_batch.shape[0])

    def get_value(self, groups=None, states=None):
        totals, masks, preds, _ = self._collect(states)

        def stats(tot, msk, prd):
            tot_marginal = tot.sum(0).astype('float32')
            tot_marginal /= max(tot_marginal.sum(), 1e-8)
            mask_marginal = msk.sum(0).astype('float32')
            mask_marginal /= max(mask_marginal.sum(), 1e-8)
            freq_diff = (prd - msk).sum(0) / (msk.sum(0) + 1e-3)
            out = {}
            out.update({f'total_freq/{self.segm_idx2name[i]}': v
                        for i, v in enumerate(tot_marginal) if v > 0})
            out.update({f'mask_freq/{self.segm_idx2name[i]}': v
                        for i, v in enumerate(mask_marginal) if v > 0})
            out.update({f'mask_freq_diff/{self.segm_idx2name[i]}': v
                        for i, v in enumerate(freq_diff) if tot_marginal[i] > 0})
            return out

        total_results = stats(totals, masks, preds)
        if groups is None:
            self.reset()
            return total_results, None
        group_results = {}
        for label, index in get_groupings(groups).items():
            group_results[label] = stats(totals[index], masks[index], preds[index])
        self.reset()
        return total_results, group_results


class SegmentationAwareSSIM(SegmentationAwarePairwiseScore):
    """Per-image SSIM (float32, as lama_tpu's), attributed to classes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._ssim = SSIMScore(device=self.device)

    @torch.no_grad()
    def calc_score(self, pred_batch, target_batch, mask):
        with no_tf32():
            return self._ssim.values(
                to_device_nchw(pred_batch, self.device),
                to_device_nchw(target_batch, self.device)).cpu().numpy()


class SegmentationAwareLPIPS(SegmentationAwarePairwiseScore):
    """Per-image LPIPS (net-lin vgg16, float32), attributed to classes; the
    weights are LPIPSScore's (LAMA_LPIPS_VGG_WEIGHTS,
    LAMA_LPIPS_LIN_WEIGHTS)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lpips = LPIPSScore(device=self.device)

    @torch.no_grad()
    def calc_score(self, pred_batch, target_batch, mask):
        with no_tf32():
            return self._lpips.values(
                to_device_nchw(pred_batch, self.device),
                to_device_nchw(target_batch, self.device)).cpu().numpy().ravel()


def _fid_without_image(img_i, activations_pred, activations_target):
    a = activations_pred.copy()
    a[img_i] = activations_target[img_i]
    mu1, s1 = a.mean(0), np.cov(a, rowvar=False)
    mu2, s2 = activations_target.mean(0), np.cov(activations_target, rowvar=False)
    return calculate_frechet_distance(mu1, s1, mu2, s2)


_LEAVE_ONE_OUT = {}
# the cores shared out among the workers' BLAS pools, as joblib shares them
# for lama_tpu's: with a full pool in each process the workers' threads
# oversubscribe the cores and each sqrtm runs many times slower
_THREAD_VARS = ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS')


def _set_activations(activations_pred, activations_target):
    _LEAVE_ONE_OUT['pred'] = activations_pred
    _LEAVE_ONE_OUT['target'] = activations_target


def _worker_fid_without_image(img_i):
    return _fid_without_image(img_i, _LEAVE_ONE_OUT['pred'],
                              _LEAVE_ONE_OUT['target'])


@contextlib.contextmanager
def _blas_threads_in_children(n):
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: str(n) for k in _THREAD_VARS})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def leave_one_out_fids(activations_pred, activations_target):
    """The FID with each image's prediction replaced by its target, in a
    pool of spawned processes, at most one per core, which share the cores
    out among their BLAS threads; the results come in the images' order.
    Each worker receives the activations once and then only image
    indices."""
    n = activations_pred.shape[0]
    cores = os.cpu_count() or 1
    workers = min(n, cores)
    with _blas_threads_in_children(max(1, cores // workers)), ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context('spawn'),
            initializer=_set_activations,
            initargs=(activations_pred, activations_target)) as pool:
        return list(pool.map(_worker_fid_without_image, range(n)))


class SegmentationAwareFID(SegmentationAwarePairwiseScore):
    """FID per-class attribution by leave-one-out deltas (reference
    base_loss.py:439-528) on the 2048-d pool, eps 1e-6; the InceptionV3 is
    FIDScore's, on `device`."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.inception = InceptionActivations.get(device=self.device)

    def calc_score(self, pred_batch, target_batch, mask):
        return self.inception(pred_batch), self.inception(target_batch)

    def get_value(self, groups=None, states=None):
        totals, masks, preds, activation_pairs = self._collect(states)
        act_pred = np.concatenate([p for p, _ in activation_pairs], axis=0)
        act_target = np.concatenate([t for _, t in activation_pairs], axis=0)

        def results(class_freq, a_pred, a_target):
            real_fid = calculate_frechet_distance(
                a_pred.mean(0), np.cov(a_pred, rowvar=False),
                a_target.mean(0), np.cov(a_target, rowvar=False))
            return {'mean': real_fid, 'std': 0,
                    **self._distribute_fid(class_freq, a_pred, a_target,
                                           real_fid)}

        total_results = results(masks, act_pred, act_target)
        if groups is None:
            self.reset()
            return total_results, None
        group_results = {}
        for label, index in get_groupings(groups).items():
            if len(index) > 1:
                group_results[label] = results(masks[index], act_pred[index],
                                               act_target[index])
            else:
                group_results[label] = dict(mean=float('nan'), std=0)
        self.reset()
        return total_results, group_results

    def _distribute_fid(self, class_freq, act_pred, act_target, real_fid):
        errors = real_fid - np.asarray(leave_one_out_fids(act_pred, act_target))
        return distribute_values_to_classes(class_freq, errors, self.segm_idx2name)
