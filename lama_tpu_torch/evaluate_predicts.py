"""Offline scores of precomputed predictions: `python -m
lama_tpu_torch.evaluate_predicts`, the counterpart of
bin/evaluate_predicts.py (reference bin/evaluate_predicts.py).

Usage:
  python -m lama_tpu_torch.evaluate_predicts <config.yaml> <datadir> \
      <predictdir> <outpath.tsv> [--metrics ssim,lpips,fid] [--device cuda|cpu]

config: e.g. configs/eval2.yaml (evaluator_kwargs, dataset_kwargs). The
prediction of <datadir>/<rel>/x_mask.png is read from
<predictdir>/<rel>/x_mask<inpainted_suffix>, the name that
`python -m lama_tpu_torch.predict` writes. SSIM, LPIPS (vgg16) and FID run
on the card in float32 with TF32 off, unless --device cpu is asked for;
without a card the default fails. The segmentation-aware scores
(segm_stats, segm_ssim, segm_lpips, segm_fid: per-ADE20k-class columns)
are there when the config sets evaluator_kwargs.segmentation (e.g.
configs/eval2_segm.yaml) or --metrics names one; they share one ADE20k
segmenter, whose weights are the ADE20k pair under $TORCH_HOME, else
seeded random weights. Without --metrics only ssim, lpips and fid run. Writes the tab-separated table of
bin/evaluate_predicts.py (rows: total and each non-empty mask-area bin;
columns: metric x mean / std, four decimals), built with the csv module:
pandas is not a dependency of the port. The score nets take their
published weights from LAMA_FID_INCEPTION_WEIGHTS and
LAMA_LPIPS_VGG_WEIGHTS when those files exist, else seeded random weights.
"""
import argparse
import logging
import os
import time

import yaml

from .evaluation.utils import results_to_tsv
from .predict import resolve_device

LOGGER = logging.getLogger(__name__)


def run_evaluation(config: dict, datadir: str, predictdir: str, metrics=None,
                   device='cuda') -> dict:
    """The eval2 protocol: the precomputed-results dataset and the score
    stack of an eval config dict; returns {(metric, group): {stat: value}}."""
    from .data.datasets import PrecomputedInpaintingResultsDataset
    from .evaluation.evaluator import InpaintingEvaluator, lpips_fid100_f1
    from .evaluation.scores import FIDScore, LPIPSScore, SSIMScore

    dataset = PrecomputedInpaintingResultsDataset(
        datadir, predictdir, **config.get('dataset_kwargs', {}))
    ctors = {'ssim': SSIMScore, 'lpips': LPIPSScore, 'fid': FIDScore}
    if config.get('evaluator_kwargs', {}).get('segmentation') or \
            (metrics and 'segm' in metrics):
        from .evaluation.segm_scores import (SegmentationAwareFID,
                                             SegmentationAwareLPIPS,
                                             SegmentationAwareSSIM,
                                             SegmentationClassStats)
        ctors.update({'segm_stats': SegmentationClassStats,
                      'segm_ssim': SegmentationAwareSSIM,
                      'segm_lpips': SegmentationAwareLPIPS,
                      'segm_fid': SegmentationAwareFID})
    enabled = metrics.split(',') if metrics else ['ssim', 'lpips', 'fid']
    unknown = [name for name in enabled if name not in ctors]
    if unknown:
        raise ValueError(f'unknown metrics {unknown}: expected some of '
                         f'{sorted(ctors)}')
    segm_kwargs = {}
    if any(name.startswith('segm') for name in enabled):
        from .models.aux.segmentation import SegmentationModule
        segm_kwargs = dict(segm_network=SegmentationModule(   # one for all
            weights_path=os.environ.get('TORCH_HOME'), device=device))
    scores = {k: ctors[k](device=device,
                          **(segm_kwargs if k.startswith('segm') else {}))
              for k in enabled}

    ev_kwargs = dict(config.get('evaluator_kwargs', {}))
    ev_kwargs.pop('device', None)
    ev_kwargs.pop('segmentation', None)
    has_integral = 'lpips' in scores and 'fid' in scores
    evaluator = InpaintingEvaluator(
        dataset, scores=scores,
        integral_title='lpips_fid100_f1' if has_integral else None,
        integral_func=lpips_fid100_f1 if has_integral else None,
        **ev_kwargs)
    return evaluator.evaluate()


def main(args):
    logging.basicConfig(level=logging.INFO, force=True)
    device = resolve_device(args.device)
    with open(args.config) as f:
        config = yaml.safe_load(f)
    t0 = time.perf_counter()
    results = run_evaluation(config, args.datadir, args.predictdir,
                             metrics=args.metrics, device=device)
    table = results_to_tsv(results)
    with open(args.outpath, 'w') as f:
        f.write(table)
    LOGGER.info(f'evaluated in {time.perf_counter() - t0:.1f} s on {device}')
    print(table, end='')
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('config', help='eval config, e.g. configs/eval2.yaml')
    parser.add_argument('datadir', help='dir with images and masks')
    parser.add_argument('predictdir', help='dir with predictions')
    parser.add_argument('outpath', help='output table path (.tsv/.csv)')
    parser.add_argument('--metrics', default=None,
                        help='comma list of ssim, lpips, fid, segm_stats, '
                        'segm_ssim, segm_lpips, segm_fid (default: ssim, '
                        'lpips, fid)')
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    return parser.parse_args(argv)


if __name__ == '__main__':
    main(parse_args())
