"""Pre-warm a serving deployment on the card: `python -m
lama_tpu_torch.precompile`, the counterpart of bin/precompile.py.

Usage:
  python -m lama_tpu_torch.precompile model.path=<run_dir> \
      shapes=512x512,1000x760 [batch_size=16] [precision=bf16] [refine=false] \
      [metrics=ssim,lpips,fid] [metrics_batches=8,1] [quant_calibration=K] \
      [quant_zero_pad=true] [spectral_bf16_store=true] [s2d_out_head=true] \
      [xfold_stem=true] [wire=fp32|uint8] [device=cuda]

It takes the predict CLI's config (configs/prediction/default.yaml) and
overrides. On the card the only state a serving process leaves to the
next is the nvcc build of the kernels (ops/kernels/_build.py: one shared
library a source, under lama_tpu_torch/_build/, keyed by a hash of the
source and the flags). cuDNN's algorithm choices, cuFFT plans and the
caching allocator's pools are per process, so they are not pre-warmed:
only the build is. The CLI
  1. builds every source of _build.SOURCES (one nvcc each, all started
     together) and logs each source's seconds, 0.0 for a library that was
     already built (nothing is built on the CPU);
  2. runs one forward of make_inpaint_forward per shape x batch_size, at
     the bucket-padded shape the predict CLI serves it at
     (serving.bucket_shape), on zeros with a square hole;
  3. with refine=true, runs one refine_predict per original size instead
     (its pyramid depends on the original size);
  4. with metrics=..., runs one forward of each score net (SSIM, LPIPS,
     the FID InceptionV3) per original shape x metrics_batches entry.
Each step logs its seconds. quant_calibration=K (int8 only) calibrates the
static scales on one zero image of each bucket shape first, as a serving
process calibrates before its first forward. spatial_shards > 1 raises
(ROADMAP queue 1 item 11b), as in the predict CLI. device defaults to cuda
and fails without a card; device=cpu runs the same forwards on the CPU's
plain versions.
"""
import logging
import os
import sys
import time
import traceback

import numpy as np
import torch

from .config import compose
from .evaluation.refinement import check_refinable, refine_predict
from .ops.kernels import _build
from .predict import CONFIG_DIR, resolve_device
from .serving import (bucket_shape, calibrate_int8, load_serving_model,
                      make_inpaint_forward)

LOGGER = logging.getLogger(__name__)


def parse_shapes(arg):
    """'512x512,1000x760' -> [(512, 512), (1000, 760)] (H x W)."""
    return [tuple(int(v) for v in s.lower().split('x'))
            for s in str(arg).split(',') if s]


def build_kernels():
    """nvcc every kernel source (_build.build); seconds by source."""
    t0 = time.perf_counter()
    seconds = _build.build()
    LOGGER.info(f'kernel build: {time.perf_counter() - t0:.1f} s ('
                + ', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())
                + ')')
    return seconds


def _zeros_with_hole(b, h, w, hole, device, dtype=torch.float32):
    """A zero image and a mask with `hole` (rows, cols slices) set."""
    image = torch.zeros((b, h, w, 3), dtype=dtype, device=device)
    mask = torch.zeros((b, h, w, 1), dtype=dtype, device=device)
    mask[:, hole[0], hole[1]] = 1
    return image, mask


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def warm_metrics(names, shapes, batches, device):
    """One forward of each score net per shape and batch; seconds by
    (h, w, b)."""
    from .evaluation.fid import InceptionActivations
    from .evaluation.scores import LPIPSScore, SSIMScore
    nets = {}
    for name in names:
        if name == 'ssim':
            nets[name] = SSIMScore(device=device)
        elif name == 'lpips':
            nets[name] = LPIPSScore(device=device)
        elif name == 'fid':
            nets[name] = InceptionActivations.get(device=device)
        else:
            raise ValueError(f'metrics: {name!r} (expected ssim, lpips, fid)')
    seconds = {}
    for h, w in shapes:
        for b in batches:
            t0 = time.perf_counter()
            x = torch.zeros((b, 3, h, w), device=device)
            with torch.no_grad():
                for name, net in nets.items():
                    if name == 'fid':
                        net.activations(x)
                    else:
                        net.values(x, x)
            _sync(device)
            seconds[h, w, b] = time.perf_counter() - t0
            LOGGER.info(f'metrics {list(nets)} {h}x{w} b{b}: '
                        f'{seconds[h, w, b]:.2f} s')
    return seconds


def main(argv):
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = compose(CONFIG_DIR, 'default', argv)
    if int(cfg.get('spatial_shards', 0) or 0) > 1:
        raise NotImplementedError(f'spatial_shards={cfg.get("spatial_shards")}'
                                  ' is not ported yet (ROADMAP queue 1 item '
                                  '11b)')
    device = resolve_device(str(cfg.get('device', 'cuda')))
    precision = str(cfg.get('precision', 'bf16'))
    use_refine = bool(cfg.get('refine', False))
    if use_refine and precision == 'int8':
        raise ValueError('refine=true is incompatible with precision=int8; '
                         'use precision=bf16 or fp32')
    report = {'build': build_kernels() if device.type == 'cuda' else {},
              'predict': {}, 'refine': {}, 'metrics': {}}
    generator, _ = load_serving_model(
        cfg.model.path, checkpoint=str(cfg.model.checkpoint),
        precision=precision, device=device,
        quant_zero_pad=bool(cfg.get('quant_zero_pad', False)),
        spectral_bf16_store=bool(cfg.get('spectral_bf16_store', False)),
        s2d_out_head=bool(cfg.get('s2d_out_head', False)),
        xfold_stem=bool(cfg.get('xfold_stem', False)))
    shapes = parse_shapes(cfg.get('shapes', '512x512'))
    batch = max(1, int(cfg.get('batch_size', 16)))
    modulo = int(cfg.dataset.pad_out_to_modulo)
    bucket = int(cfg.get('pad_to_bucket', 64))
    buckets = [bucket_shape(h, w, modulo, bucket) for h, w in shapes]

    if int(cfg.get('quant_calibration', 0) or 0) > 0:
        if precision != 'int8':
            raise ValueError('quant_calibration requires precision=int8')
        calibrate_int8(generator, [
            (np.zeros((1, bh, bw, 3), np.float32),
             np.zeros((1, bh, bw, 1), np.float32)) for bh, bw in buckets])

    if use_refine:
        check_refinable(generator)
        for (h, w), (bh, bw) in zip(shapes, buckets):
            t0 = time.perf_counter()
            image, mask = _zeros_with_hole(
                1, bh, bw, (slice(h // 4, h // 2), slice(w // 4, w // 2)),
                device)
            refine_predict(image, mask, generator, unpad_to_size=(h, w),
                           **dict(cfg.refiner))
            _sync(device)
            report['refine'][h, w] = time.perf_counter() - t0
            LOGGER.info(f'refine {h}x{w}: {report["refine"][h, w]:.1f} s')
    else:
        wire = str(cfg.get('wire', 'fp32'))
        predict = make_inpaint_forward(generator, wire=wire,
                                       out_key=str(cfg.get('out_key',
                                                           'inpainted')))
        dtype = torch.uint8 if wire == 'uint8' else torch.float32
        for (h, w), (bh, bw) in zip(shapes, buckets):
            t0 = time.perf_counter()
            image, mask = _zeros_with_hole(
                batch, bh, bw, (slice(bh // 4, bh // 2), slice(bw // 4,
                                                              bw // 2)),
                device, dtype)
            predict(image, mask)
            _sync(device)
            report['predict'][h, w] = time.perf_counter() - t0
            LOGGER.info(f'predict {h}x{w} -> bucket {bh}x{bw} b{batch}: '
                        f'{report["predict"][h, w]:.2f} s')

    if cfg.get('metrics'):
        batches = [int(v) for v in
                   str(cfg.get('metrics_batches', '8')).split(',') if v]
        report['metrics'] = warm_metrics(
            [m for m in str(cfg.metrics).split(',') if m], shapes, batches,
            device)
    LOGGER.info(f'Pre-warmed {len(shapes)} shape(s).')
    return report


if __name__ == '__main__':
    try:
        main(sys.argv[1:])
    except KeyboardInterrupt:
        LOGGER.warning('Interrupted by user')
        sys.exit(1)
    except Exception as ex:
        LOGGER.critical(f'Precompile failed due to {ex}:\n'
                        f'{traceback.format_exc()}')
        sys.exit(1)
