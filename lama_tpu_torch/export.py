"""Export the inpainter as a `torch.export` program: `python -m
lama_tpu_torch.export`, the counterpart of bin/to_stablehlo.py (the
reference's bin/to_jit.py).

Usage:
  python -m lama_tpu_torch.export model.path=<run_dir> outdir=<dir> \
      [model.checkpoint=best.ckpt] [height=512] [width=512] [device=cuda] \
      [precision=fp32|bf16|int8] [quant_zero_pad=true] \
      [spectral_bf16_store=true] [s2d_out_head=true] \
      [calibration_indir=<image/mask dir>] [calibration_img_suffix=.png]

The generator is loaded as the predict CLI loads it
(serving.load_serving_model) and wrapped as serving.Inpainter, the module
that make_inpaint_forward serves: (image (1, H, W, 3), mask (1, H, W, 1))
float32 in [0, 1] -> the inpainted image (1, H, W, 3), known pixels kept.
It is exported with torch.export.export and written with torch.export.save
to <outdir>/inpainter_<H>x<W>[_bf16|_int8].pt2. The graph calls the port's
kernels as registered ops (ops/kernels/library.py), so the program runs
them on the card as eager serving does. The packed weights the kernels
take (the FourierUnit's folded BN, the int8 codes and scales) are computed
once before exporting (`freeze_for_export`) and held by the program as
constants, as the parameters are. With precision=int8 and
calibration_indir, the static activation scales are calibrated on those
images (each cropped to H x W, padded 'symmetric' to it, the mask
thresholded at 0, as bin/to_stablehlo.py:66-88) and land in the program as
buffers: it then holds no amax reduction.

The file is then loaded back with torch.export.load and run on a seeded
input (bin/to_stablehlo.py:112-114); the run fails unless its max |diff|
from the direct call is under 1e-4 in fp32, 2e-2 in bf16 and int8
(:120-123). The CLI logs that max |diff| and the file's size; `main`
returns them with the loaded program and the module it exported.

A process that loads the program needs torch and the op registrations
only:

    import torch
    import lama_tpu_torch.ops.kernels.library  # noqa: F401
    inpaint = torch.export.load('inpainter_512x512.pt2').module()

device defaults to cuda and fails without a card; device=cpu exports the
CPU program (the plain versions behind the same ops).
"""
import logging
import os
import sys
import traceback

import numpy as np
import torch

from .config import with_overrides
from .predict import resolve_device
from .serving import Inpainter, calibrate_int8, load_serving_model

LOGGER = logging.getLogger(__name__)
DEFAULTS = {'model': {'path': None, 'checkpoint': 'best.ckpt'},
            'outdir': None, 'height': 512, 'width': 512, 'device': 'cuda',
            'precision': 'fp32', 'quant_zero_pad': False,
            'spectral_bf16_store': False, 's2d_out_head': False,
            'calibration_indir': None, 'calibration_img_suffix': '.png'}
TOLERANCE = {'fp32': 1e-4, 'bf16': 2e-2, 'int8': 2e-2}


def calibration_pairs(indir, img_suffix, h, w):
    """bin/to_stablehlo.py:66-88: each image and mask of `indir` cropped to
    h x w, padded 'symmetric' up to it, the mask > 0."""
    from .data.datasets import make_default_val_dataset
    ds = make_default_val_dataset(indir if indir.endswith('/') else indir + '/',
                                  img_suffix=img_suffix, pad_out_to_modulo=8)
    pairs = []
    for i in range(len(ds)):
        item = ds[i]
        image, mask = item['image'][:h, :w], item['mask'][:h, :w]
        ph, pw = h - image.shape[0], w - image.shape[1]
        if ph or pw:
            pads = ((0, ph), (0, pw), (0, 0))
            image = np.pad(image, pads, mode='symmetric')
            mask = np.pad(mask, pads, mode='symmetric')
        pairs.append((image[None].astype(np.float32),
                      (mask[None] > 0).astype(np.float32)))
    return pairs


def seeded_input(h, w, device):
    """bin/to_stablehlo.py:112-114: RandomState(0) image, mask > 0.8."""
    rng = np.random.RandomState(0)
    image = rng.rand(1, h, w, 3).astype(np.float32)
    mask = (rng.rand(1, h, w, 1) > 0.8).astype(np.float32)
    return (torch.from_numpy(image).to(device),
            torch.from_numpy(mask).to(device))


def export_inpainter(module, h, w, device):
    """torch.export of `module` at (1, h, w, 3), (1, h, w, 1) float32,
    after each submodule with a packed-weight cache has filled its export
    buffers from the current weights (`freeze_for_export`)."""
    spec = (torch.zeros(1, h, w, 3, device=device),
            torch.zeros(1, h, w, 1, device=device))
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, 'freeze_for_export'):
                m.freeze_for_export()
        return torch.export.export(module, spec)


def main(argv):
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = with_overrides(DEFAULTS, argv)
    precision = str(cfg.precision)
    if precision not in TOLERANCE:
        raise ValueError(f'precision={precision!r}: expected fp32, bf16 or '
                         'int8')
    for key in ('model.path', 'outdir'):
        if not isinstance(cfg.select(key), str):
            raise ValueError(f'{key} must be given ({key}=<path>)')
    device = resolve_device(str(cfg.device))
    generator, _ = load_serving_model(
        cfg.model.path, checkpoint=str(cfg.model.checkpoint),
        precision=precision, device=device,
        quant_zero_pad=bool(cfg.quant_zero_pad),
        spectral_bf16_store=bool(cfg.spectral_bf16_store),
        s2d_out_head=bool(cfg.s2d_out_head))
    h, w = int(cfg.height), int(cfg.width)
    if cfg.calibration_indir:
        if precision != 'int8':
            raise ValueError('calibration_indir requires precision=int8')
        pairs = calibration_pairs(str(cfg.calibration_indir),
                                  str(cfg.calibration_img_suffix or '.png'),
                                  h, w)
        calibrate_int8(generator, pairs)
        LOGGER.info(f'int8 static scales calibrated on {len(pairs)} image(s) '
                    f'from {cfg.calibration_indir}')

    module = Inpainter(generator).eval()
    exported = export_inpainter(module, h, w, device)
    os.makedirs(cfg.outdir, exist_ok=True)
    suffix = '' if precision == 'fp32' else f'_{precision}'
    path = os.path.join(cfg.outdir, f'inpainter_{h}x{w}{suffix}.pt2')
    torch.export.save(exported, path)
    size = os.path.getsize(path)
    LOGGER.info(f'Saved {size} bytes to {path}')

    # parity: the reloaded program against the direct call (to_jit.py:68-72)
    image, mask = seeded_input(h, w, device)
    restored = torch.export.load(path).module()
    with torch.no_grad():
        direct = module(image, mask)
        loaded = restored(image, mask)
    diff = float((direct - loaded).abs().max())
    LOGGER.info(f'Export parity max |diff| = {diff:.2e}')
    if not diff < TOLERANCE[precision]:
        raise AssertionError(f'exported program differs from the direct '
                             f'call by {diff} (bound {TOLERANCE[precision]})')
    return dict(path=path, bytes=size, max_abs_diff=diff, program=restored,
                module=module)


if __name__ == '__main__':
    try:
        main(sys.argv[1:])
    except Exception as ex:
        LOGGER.critical(f'Export failed due to {ex}:\n{traceback.format_exc()}')
        sys.exit(1)
