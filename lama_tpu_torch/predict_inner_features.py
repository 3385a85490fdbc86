"""L2-norm heat maps of the generator's intermediate activations:
`python -m lama_tpu_torch.predict_inner_features`, the counterpart of
bin/predict_inner_features.py (reference bin/predict_inner_features.py).

Usage:
  python -m lama_tpu_torch.predict_inner_features model.path=<run> \
      indir=<d> outdir=<o> [model.checkpoint=best.ckpt] [levels=[1,2,3,4]] \
      [hole_radius=60] [device=cuda]

Forward hooks on `generator.model[i]` for each level i take the place of
flax's capture_intermediates on `model_<i>` (the port keeps the
reference's `model.N` indices); as there, only entries with parameters or
buffers are captured (lama_tpu names no module for a pad, an activation or
the tuple concat). A (local, global) tuple is concatenated channel-wise,
None skipped. Each image of indir (padded to a multiple of 8) gets a
centred square hole of side 2 * hole_radius and runs once through the
generator at fp32; each captured level is written as
<outdir>/<name>_lev<ii>_norm.png: sqrt(mean over channels of x^2), minus
its min, over its std + 1e-8, clipped to [0, 1], times 255
(`heat_map`). device defaults to cuda (the kernels) and fails without a
card; device=cpu runs the plain versions.
"""
import logging
import os
import sys
import traceback

import cv2
import numpy as np
import torch

from .config import with_overrides
from .data.datasets import make_default_val_dataset
from .predict import resolve_device
from .serving import load_serving_model

LOGGER = logging.getLogger(__name__)
DEFAULTS = {'model': {'path': None, 'checkpoint': 'best.ckpt'},
            'indir': None, 'outdir': None,
            'dataset': {'kind': 'default', 'img_suffix': '.png',
                        'pad_out_to_modulo': 8},
            'levels': [1, 2, 3, 4], 'hole_radius': 60, 'device': 'cuda'}


def heat_map(feats) -> np.ndarray:
    """(C, H, W) activations -> the float heat map (H, W) in [0, 255]
    before the uint8 cast (bin/predict_inner_features.py:92-97)."""
    heat = torch.sqrt(torch.mean(torch.square(feats.float()), dim=0))
    heat = heat.cpu().numpy()
    heat = heat - heat.min()
    heat = heat / (heat.std() + 1e-8)
    return np.clip(heat, 0, 1) * 255


def capture(generator, levels):
    """Forward hooks on generator.model[i], i in `levels`, for the entries
    with parameters or buffers; returns (outputs by level, hook handles).
    A (local, global) output is concatenated channel-wise, None skipped."""
    outputs, handles = {}, []
    for i in sorted(levels):
        if i >= len(generator.model):
            continue
        module = generator.model[i]
        if not (any(True for _ in module.parameters())
                or any(True for _ in module.buffers())):
            continue

        def hook(mod, inputs, out, i=i):
            if isinstance(out, tuple):
                out = torch.cat([t for t in out if t is not None], dim=1)
            outputs[i] = out
        handles.append(module.register_forward_hook(hook))
    return outputs, handles


def main(argv):
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = with_overrides(DEFAULTS, argv)
    for key in ('model.path', 'indir', 'outdir'):
        if not isinstance(cfg.select(key), str):
            raise ValueError(f'{key} must be given ({key}=<path>)')
    device = resolve_device(str(cfg.device))
    generator, _ = load_serving_model(cfg.model.path,
                                      checkpoint=str(cfg.model.checkpoint),
                                      precision='fp32', device=device)
    indir = cfg.indir if cfg.indir.endswith('/') else cfg.indir + '/'
    dataset = make_default_val_dataset(indir, **dict(cfg.dataset))
    outputs, handles = capture(generator, set(int(v) for v in cfg.levels))
    r = int(cfg.hole_radius)
    try:
        for img_i in range(len(dataset)):
            mask_fname = dataset.mask_filenames[img_i]
            out_fname = os.path.join(
                cfg.outdir, os.path.splitext(mask_fname[len(indir):])[0])
            os.makedirs(os.path.dirname(out_fname), exist_ok=True)
            img = torch.from_numpy(dataset[img_i]['image'][None]).to(device)
            h, w = img.shape[1:3]
            mask = torch.zeros((1, h, w, 1), device=device)
            mask[:, h // 2 - r:h // 2 + r, w // 2 - r:w // 2 + r] = 1
            x = torch.cat([img * (1 - mask), mask], dim=-1)
            outputs.clear()
            with torch.inference_mode():
                generator(x.permute(0, 3, 1, 2))
                for level, feats in sorted(outputs.items()):
                    cv2.imwrite(out_fname + f'_lev{level:02d}_norm.png',
                                heat_map(feats[0]).astype('uint8'))
    finally:
        for handle in handles:
            handle.remove()
    LOGGER.info(f'Inner feature maps written to {cfg.outdir}')


if __name__ == '__main__':
    try:
        main(sys.argv[1:])
    except Exception as ex:
        LOGGER.critical(f'Failed due to {ex}:\n{traceback.format_exc()}')
        sys.exit(1)
