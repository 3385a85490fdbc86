"""FID between two image folders: `python -m lama_tpu_torch.fid_score`,
the counterpart of bin/fid_score.py (the reference's vendored
evaluation/losses/fid/fid_score.py CLI).

Usage:
  python -m lama_tpu_torch.fid_score <path1> <path2> [--batch-size 50] \
      [--weights pt_inception.pth] [--device cuda|cpu]

Reads every jpg / jpeg / png under each folder (sorted, recursively),
batches them cropped to the batch's smallest height and width, as
bin/fid_score.py does, and prints `FID: <value> (<n1> vs <n2> images)`. The
FID InceptionV3 runs on the card in float32 with TF32 off unless --device
cpu is asked for; its weights are `--weights` (or
LAMA_FID_INCEPTION_WEIGHTS) when the file exists, else seeded random ones.
"""
import argparse
import glob
import os

import numpy as np

from .data.io import load_image
from .predict import resolve_device


def folder_activations(path, inception, batch_size, exts=('jpg', 'jpeg', 'png')):
    files = sorted(f for ext in exts
                   for f in glob.glob(os.path.join(path, '**', f'*.{ext}'),
                                      recursive=True))
    if not files:
        raise FileNotFoundError(f'no images under {path}')
    acts = []
    for start in range(0, len(files), batch_size):
        imgs = [load_image(f) for f in files[start:start + batch_size]]
        hmin = min(i.shape[0] for i in imgs)
        wmin = min(i.shape[1] for i in imgs)
        batch = np.stack([i[:hmin, :wmin] for i in imgs])
        acts.append(inception(batch))
    return np.concatenate(acts)


def main(args):
    from .evaluation.fid import InceptionActivations, fid_from_activations
    device = resolve_device(args.device)
    inception = InceptionActivations.get(device=device,
                                         weights_path=args.weights)
    act1 = folder_activations(args.path1, inception, args.batch_size)
    act2 = folder_activations(args.path2, inception, args.batch_size)
    fid = fid_from_activations(act1, act2)
    print(f'FID: {fid:.4f} ({act1.shape[0]} vs {act2.shape[0]} images)')
    return fid


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('path1')
    parser.add_argument('path2')
    parser.add_argument('--batch-size', type=int, default=50)
    parser.add_argument('--weights', default=None,
                        help='pt_inception-2015-12-05 torch weights path')
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    return parser.parse_args(argv)


if __name__ == '__main__':
    main(parse_args())
