"""Inpainting CLI of the port: `python -m lama_tpu_torch.predict`, the
counterpart of bin/predict.py.

Usage:
  python -m lama_tpu_torch.predict model.path=<run_dir> indir=<images+masks> \
      outdir=<out> [device=cuda] [precision=bf16|fp32|int8] [batch_size=N] \
      [wire=fp32|uint8] [out_key=inpainted|predicted_image] [refine=true] \
      [quant_calibration=K] [quant_zero_pad=true] [spectral_bf16_store=true] \
      [s2d_out_head=true] [xfold_stem=true]

It takes the same key=value overrides of configs/prediction/default.yaml.
<run_dir>/config.yaml names the generator: ffc_resnet (big-lama) or
pix2pixhd_global (lama-regular, big-lama-regular). <run_dir>/models/
<checkpoint> is a reference-format .ckpt. Images are padded to
`dataset.pad_out_to_modulo` and then to `pad_to_bucket` (numpy
'symmetric'), grouped `batch_size` at a time by padded shape, and cropped
back on write. `device` defaults to cuda (the YAML's `tpu` reads as cuda
here) and the run fails without a card unless device=cpu is asked for.
refine=true runs the multiscale refiner (evaluation/refinement.py) one image
at a time with the YAML's `refiner:` options, and writes the refined size,
which px_budget may have scaled down; it refuses precision=int8, as
bin/predict.py does, and a generator without front and rear stages (every
kind but ffc_resnet) before any image is read. precision=int8 serves the
eligible convs in int8 (serving.load_serving_model); quant_calibration=K
records their static activation scales on the first K images, padded as
they are served (bin/predict.py:106-127), and requires int8. The serving
options are load_serving_model's. spatial_shards is a later ROADMAP item
and raises.
"""
import logging
import os
import sys
import traceback

import numpy as np
import torch

from .config import compose
from .data.datasets import make_default_val_dataset
from .data.io import save_image
from .evaluation.refinement import check_refinable, refine_predict
from .serving import (bucket_shape, calibrate_int8, load_serving_model,
                      make_inpaint_forward)

LOGGER = logging.getLogger(__name__)
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs', 'prediction')


def resolve_device(name: str) -> torch.device:
    """cuda (also for the YAML's `tpu`) or an explicit cpu; never a silent
    switch from one to the other."""
    name = {'tpu': 'cuda'}.get(name, name)
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device=cuda but CUDA is not available; pass '
                           'device=cpu to run on the CPU')
    if device.type not in ('cuda', 'cpu'):
        raise ValueError(f'device={name!r}: expected cuda or cpu')
    return device


def main(argv):
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = compose(CONFIG_DIR, 'default', argv)
    if cfg.get('spatial_shards'):
        raise NotImplementedError(f'spatial_shards={cfg.get("spatial_shards")}'
                                  ' is not ported yet (ROADMAP queue 1 item '
                                  '11b)')
    use_refine = bool(cfg.get('refine', False))
    if use_refine and str(cfg.get('precision', 'bf16')) == 'int8':
        # the refiner differentiates through the rear of the generator;
        # int8's rounding has no gradient (bin/predict.py:61-68)
        raise ValueError('refine=true is incompatible with precision=int8 '
                         '(quantization blocks the refinement gradients); '
                         'use precision=bf16 or fp32')
    model_path = cfg.model.path
    if not isinstance(model_path, str) or model_path in ('', 'no'):
        raise ValueError('model.path must be given (model.path=<run dir>)')
    for key in ('indir', 'outdir'):
        if not isinstance(cfg.get(key), str):
            raise ValueError(f'{key} must be given ({key}=<path>)')
    device = resolve_device(str(cfg.get('device', 'cuda')))

    generator, _ = load_serving_model(
        model_path, checkpoint=str(cfg.model.checkpoint),
        precision=str(cfg.get('precision', 'bf16')), device=device,
        quant_zero_pad=bool(cfg.get('quant_zero_pad', False)),
        spectral_bf16_store=bool(cfg.get('spectral_bf16_store', False)),
        s2d_out_head=bool(cfg.get('s2d_out_head', False)),
        xfold_stem=bool(cfg.get('xfold_stem', False)))
    if use_refine:
        check_refinable(generator)

    out_ext = cfg.get('out_ext', '.png')
    modulo = cfg.dataset.pad_out_to_modulo
    bucket = int(cfg.get('pad_to_bucket', 64))
    indir = cfg.indir if cfg.indir.endswith('/') else cfg.indir + '/'
    dataset = make_default_val_dataset(indir, **dict(cfg.dataset))

    # quant_calibration=K (int8 only): static activation scales from the
    # first K images, padded as they are served (bin/predict.py:106-127)
    calib_n = int(cfg.get('quant_calibration', 0) or 0)
    if calib_n > 0:
        if str(cfg.get('precision', 'bf16')) != 'int8':
            raise ValueError('quant_calibration requires precision=int8')
        pairs = []
        for i in range(min(calib_n, len(dataset))):
            item = dataset[i]
            image, mask = item['image'], item['mask']
            bh, bw = bucket_shape(image.shape[0], image.shape[1], modulo,
                                  bucket)
            pads = ((0, bh - image.shape[0]), (0, bw - image.shape[1]),
                    (0, 0))
            image = np.pad(image, pads, mode='symmetric')
            mask = np.pad(mask, pads, mode='symmetric')
            pairs.append((image[None].astype(np.float32),
                          (mask[None] > 0).astype(np.float32)))
        calibrate_int8(generator, pairs)
        LOGGER.info(f'int8 static scales calibrated on {len(pairs)} image(s)')

    wire = str(cfg.get('wire', 'fp32'))
    predict = make_inpaint_forward(generator, wire=wire,
                                   out_key=str(cfg.get('out_key', 'inpainted')))

    batch_size = 1 if use_refine else max(1, int(cfg.get('batch_size', 1)))
    # CUDA runs asynchronously: keep up to depth-1 batches queued so host
    # reads, padding and PNG writes overlap device work (depth 1: in order)
    depth = max(1, int(cfg.get('pipeline_depth', 2)))
    in_flight = []

    def drain(keep=0):
        while len(in_flight) > keep:
            entries, out = in_flight.pop(0)
            out = out.cpu().numpy()
            for e, res in zip(entries, out):
                save_image(e['out_fname'], res[:e['orig_h'], :e['orig_w']])

    def flush(entries):
        n = len(entries)
        imgs = [e['image'] for e in entries]
        masks = [e['mask'] for e in entries]
        if n < batch_size:  # repeat the last item; the extras are dropped
            imgs += [imgs[-1]] * (batch_size - n)
            masks += [masks[-1]] * (batch_size - n)
        if wire == 'uint8':  # rint inverts the loader's /255 for 8-bit files
            img_arr = np.rint(np.stack(imgs) * 255.0).astype(np.uint8)
            mask_arr = (np.stack(masks) > 0).astype(np.uint8)
        else:
            img_arr = np.stack(imgs).astype(np.float32)
            mask_arr = (np.stack(masks) > 0).astype(np.float32)
        out = predict(torch.from_numpy(img_arr).to(device),
                      torch.from_numpy(mask_arr).to(device))
        in_flight.append((entries, out[:n]))
        drain(depth - 1)

    groups = {}
    for i in range(len(dataset)):
        mask_fname = dataset.mask_filenames[i]
        out_fname = os.path.join(
            cfg.outdir, os.path.splitext(mask_fname[len(indir):])[0] + out_ext)
        item = dataset[i]
        image, mask = item['image'], item['mask']
        orig_h, orig_w = item.get('unpad_to_size', image.shape[:2])
        bh, bw = bucket_shape(image.shape[0], image.shape[1], modulo, bucket)
        pad_h, pad_w = bh - image.shape[0], bw - image.shape[1]
        if pad_h or pad_w:
            pads = ((0, pad_h), (0, pad_w), (0, 0))
            image = np.pad(image, pads, mode='symmetric')
            mask = np.pad(mask, pads, mode='symmetric')
        if use_refine:
            res = refine_predict(
                image[None], (mask[None] > 0).astype(np.float32), generator,
                unpad_to_size=(int(orig_h), int(orig_w)), **dict(cfg.refiner))
            # the written size is the refined one: px_budget may scale down
            save_image(out_fname, res[0].cpu().numpy())
            continue
        pending = groups.setdefault((bh, bw), [])
        pending.append(dict(image=image, mask=mask, out_fname=out_fname,
                            orig_h=int(orig_h), orig_w=int(orig_w)))
        if len(pending) >= batch_size:
            flush(pending[:])
            pending.clear()
    for pending in groups.values():
        if pending:
            flush(pending)
    drain()
    LOGGER.info(f'Predicted {len(dataset)} images to {cfg.outdir}')


if __name__ == '__main__':
    try:
        main(sys.argv[1:])
    except KeyboardInterrupt:
        LOGGER.warning('Interrupted by user')
        sys.exit(1)
    except Exception as ex:
        LOGGER.critical(f'Prediction failed due to {ex}:\n'
                        f'{traceback.format_exc()}')
        sys.exit(1)
