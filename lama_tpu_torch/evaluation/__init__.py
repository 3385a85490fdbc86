"""Evaluation of the port (counterpart of lama_tpu.evaluation): the
multiscale refiner, the scores (SSIM, LPIPS, FID), their evaluators and
`make_evaluator` (reference saicinpainting/evaluation/__init__.py:9-33),
the segmentation-aware scores, the object-shaped masks and the LPIPS
research tail."""
import logging

LOGGER = logging.getLogger(__name__)


def make_evaluator(kind='default', ssim=True, lpips=True, fid=True,
                   integral_kind=None, device='cuda', **kwargs):
    from .evaluator import InpaintingEvaluatorOnline, ssim_fid100_f1, lpips_fid100_f1
    from .scores import SSIMScore, LPIPSScore, FIDScore

    LOGGER.info(f'Make evaluator {kind} on {device}')
    metrics = {}
    if ssim:
        metrics['ssim'] = SSIMScore(device=device)
    if lpips:
        metrics['lpips'] = LPIPSScore(device=device)
    if fid:
        metrics['fid'] = FIDScore(device=device)
    if integral_kind is None:
        integral_func = None
    elif integral_kind == 'ssim_fid100_f1':
        integral_func = ssim_fid100_f1
    elif integral_kind == 'lpips_fid100_f1':
        integral_func = lpips_fid100_f1
    else:
        raise ValueError(f'Unexpected integral_kind={integral_kind}')

    if kind == 'default':
        return InpaintingEvaluatorOnline(scores=metrics, integral_func=integral_func,
                                         integral_title=integral_kind, **kwargs)
    raise ValueError(f'Unknown evaluator kind {kind}')
