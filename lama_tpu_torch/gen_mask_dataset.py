"""Offline eval-set generation: `python -m lama_tpu_torch.gen_mask_dataset`,
the counterpart of bin/gen_mask_dataset.py (reference
bin/gen_mask_dataset.py).

Usage:
  python -m lama_tpu_torch.gen_mask_dataset <config.yaml> <indir> <outdir> \
      [--n-jobs N] [--ext jpg] [--seed S] [--device cuda|cpu]

Takes a folder of images and a data_gen config (configs/data_gen/*.yaml),
resizes each image so its short side is cropping.out_min_size (upscaling,
or dropping small ones), draws masks, optionally crops a random square
holding the mask, filters by max_tamper_area, and writes
<stem>_crop###.png + <stem>_crop###_mask###.png pairs, the layout of the
evaluation datasets, named as bin/gen_mask_dataset.py names them.

generator_kind `random` draws with data/masks.py::MixedMaskGenerator (host
numpy). `segmentation` makes object-shaped masks (evaluation/masks.py)
from the ADE20k segmenter on `--device` (cuda by default; without a card it
fails unless --device cpu is asked for); the segmenter refuses to run
without the ADE20k weights under $TORCH_HOME. With --seed S, the crops and
the random masks draw from RandomState(S) and the object placements from a
second RandomState(S) (bin/gen_mask_dataset.py leaves the placements on the
unseeded global np.random); --n-jobs N splits the files into N chunks, each
run in a spawned process with the seed S + its first file's index.
"""
import argparse
import glob
import multiprocessing
import os
import traceback
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import PIL.Image as Image
import yaml


class MakeManyMasksWrapper:
    def __init__(self, impl, variants_n=2):
        self.impl = impl
        self.variants_n = variants_n

    def get_masks(self, img, rng=None):
        shape = (img.height, img.width)
        return [self.impl(shape, rng=rng)[..., 0] for _ in range(self.variants_n)]


def propose_random_square_crop(mask, min_overlap=0.5, rng=None):
    """Square crop holding >= min_overlap of the mask's extent (reference
    evaluation/masks/mask.py:410-429)."""
    r = rng or np.random
    height, width = mask.shape
    mask_ys, mask_xs = np.where(mask > 0.5)
    if height < width:
        crop_size = height
        obj_left, obj_right = mask_xs.min(), mask_xs.max()
        obj_width = obj_right - obj_left
        left_border = max(0, min(width - crop_size - 1,
                                 obj_left + obj_width * min_overlap - crop_size))
        right_border = max(left_border + 1,
                           min(width - crop_size, obj_left + obj_width * min_overlap))
        start_x = r.randint(int(left_border), int(right_border))
        return start_x, 0, start_x + crop_size, height
    crop_size = width
    obj_top, obj_bottom = mask_ys.min(), mask_ys.max()
    obj_height = obj_bottom - obj_top
    top_border = max(0, min(height - crop_size - 1,
                            obj_top + obj_height * min_overlap - crop_size))
    bottom_border = max(top_border + 1,
                        min(height - crop_size, obj_top + obj_height * min_overlap))
    start_y = r.randint(int(top_border), int(bottom_border))
    return 0, start_y, width, start_y + crop_size


def process_images(src_images, indir, outdir, config, seed=None, device='cuda'):
    from .data.masks import MixedMaskGenerator

    rng = np.random.RandomState(seed)
    kind = config['generator_kind']
    gen_kwargs = dict(config.get('mask_generator_kwargs', {}))
    if kind == 'segmentation':
        from .evaluation.masks import SegmentationMask
        from .evaluation.segm_backend import make_default_predictor
        gen_kwargs.setdefault('predictor', make_default_predictor(device=device))
        mask_generator = SegmentationMask(**gen_kwargs)
        placement_rng = np.random.RandomState(seed)
    elif kind == 'random':
        variants_n = gen_kwargs.pop('variants_n', 2)
        mask_generator = MakeManyMasksWrapper(MixedMaskGenerator(**gen_kwargs),
                                              variants_n=variants_n)
    else:
        raise ValueError(f'Unexpected generator kind: {kind}')

    cropping = config.get('cropping', {})
    out_min_size = cropping.get('out_min_size', 256)
    handle_small_mode = cropping.get('handle_small_mode', 'upscale')
    out_square_crop = cropping.get('out_square_crop', True)
    crop_min_overlap = cropping.get('crop_min_overlap', 1)
    max_tamper_area = config.get('max_tamper_area', 1)
    max_masks_per_image = config.get('max_masks_per_image', 1)

    for infile in src_images:
        try:
            file_relpath = os.path.relpath(infile, indir)
            img_outpath = os.path.join(outdir, file_relpath)
            os.makedirs(os.path.dirname(img_outpath), exist_ok=True)

            image = Image.open(infile).convert('RGB')
            if min(image.size) < out_min_size and handle_small_mode == 'drop':
                continue
            factor = out_min_size / min(image.size)
            out_size = tuple((np.array(image.size) * factor).round().astype('uint32'))
            image = image.resize(out_size, resample=Image.BICUBIC)

            if kind == 'segmentation':
                src_masks = mask_generator.get_masks(np.array(image),
                                                     rng=placement_rng)
            else:
                src_masks = mask_generator.get_masks(image, rng=rng)

            filtered = []
            for cur_mask in src_masks:
                if out_square_crop:
                    if not (cur_mask > 0.5).any():
                        continue
                    left, top, right, bottom = propose_random_square_crop(
                        cur_mask, min_overlap=crop_min_overlap, rng=rng)
                    cur_mask = cur_mask[top:bottom, left:right]
                    cur_image = image.copy().crop((left, top, right, bottom))
                else:
                    cur_image = image
                if len(np.unique(cur_mask)) == 0 or cur_mask.mean() > max_tamper_area:
                    continue
                filtered.append((cur_image, cur_mask))

            if not filtered:
                continue
            mask_indices = rng.choice(len(filtered),
                                      size=min(len(filtered), max_masks_per_image),
                                      replace=False)
            mask_basename = os.path.join(outdir, os.path.splitext(file_relpath)[0])
            for i, idx in enumerate(mask_indices):
                cur_image, cur_mask = filtered[idx]
                cur_basename = mask_basename + f'_crop{i:03d}'
                Image.fromarray(np.clip(cur_mask * 255, 0, 255).astype('uint8'),
                                mode='L').save(cur_basename + f'_mask{i:03d}.png')
                cur_image.save(cur_basename + '.png')
        except KeyboardInterrupt:
            return
        except Exception as ex:
            # as bin/gen_mask_dataset.py: report the image and go on
            print(f'Could not make masks for {infile} due to {ex}:\n'
                  f'{traceback.format_exc()}')


def main(args):
    from .predict import resolve_device
    device = str(resolve_device(args.device))
    if not args.indir.endswith('/'):
        args.indir += '/'
    os.makedirs(args.outdir, exist_ok=True)
    with open(args.config) as f:
        config = yaml.safe_load(f)

    in_files = sorted(glob.glob(os.path.join(args.indir, '**', f'*.{args.ext}'),
                                recursive=True))
    if args.n_jobs == 0:
        process_images(in_files, args.indir, args.outdir, config,
                       seed=args.seed, device=device)
        return
    n = len(in_files)
    chunk = n // args.n_jobs + (1 if n % args.n_jobs else 0)
    with ProcessPoolExecutor(max_workers=args.n_jobs,
                             mp_context=multiprocessing.get_context('spawn')) as ex:
        futures = [ex.submit(process_images, in_files[s:s + chunk], args.indir,
                             args.outdir, config,
                             None if args.seed is None else args.seed + s, device)
                   for s in range(0, n, chunk)]
        for fut in futures:
            fut.result()


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('config', help='data_gen config yaml')
    parser.add_argument('indir', help='folder with source images')
    parser.add_argument('outdir', help='output folder for image+mask pairs')
    parser.add_argument('--n-jobs', type=int, default=0)
    parser.add_argument('--ext', type=str, default='jpg')
    parser.add_argument('--seed', type=int, default=None,
                        help='optional seed (the reference leaves eval-set '
                             'generation unseeded, README.md:411)')
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    return parser.parse_args(argv)


if __name__ == '__main__':
    main(parse_args())
