"""Per-image error analysis: `python -m lama_tpu_torch.analyze_errors`, the
counterpart of bin/analyze_errors.py (reference bin/analyze_errors.py).

Usage:
  python -m lama_tpu_torch.analyze_errors configs/analyze_mask_errors.yaml \
      <datadir> <predictdir> <outpath> [--only-report] [--device cuda|cpu]

A linear SVM (evaluation/linear_svm.py, sklearn's LinearSVC(dual=False)
problem) separates the FID InceptionV3 features (models/aux/inception.py,
on the card unless --device cpu) of the real images from those of the
inpainted ones; its decision value is each image's realism score. Writes,
as the JAX CLI does: latents/*.pkl (file names, the mask -> real and mask
-> fake maps, the real and fake scores), latents/join_scores_table.csv
(tab-separated: each fake's row joined left with its real image's score,
de-duplicated on (fake_fname, real_fname)), the take_global_top worst and
best fakes beside their reals with their scores drawn on
(global_worst/, global_best/), and overlapping_mask_score_diffs.tsv, the
score differences of the mask pairs of one image that overlap by more than
min_overlap. The tables are written with the csv module: neither pandas
nor scikit-learn is a dependency of the port. --only-report rebuilds the
tables and galleries from the pickles.
"""
import argparse
import csv
import os
import pickle

import cv2
import numpy as np
import yaml

from .data.io import load_image
from .predict import resolve_device

JOIN_COLUMNS = ('mask_fname', 'fake_fname', 'real_fname', 'fake_score',
                'real_score')


def draw_score(img, score):
    """uint8 HWC image annotated with the score (reference
    analyze_errors.py:18-27)."""
    img = np.ascontiguousarray(np.clip(img * 255, 0, 255).astype('uint8'))
    cv2.putText(img, f'{score:.2f}', (40, 40), cv2.FONT_HERSHEY_SIMPLEX, 1,
                (0, 255, 0), 2)
    return img


def save_global_samples(mask_fnames, mask2real, mask2fake, out_dir,
                        real_scores, fake_scores):
    """Each fake beside its real, scores drawn on, as <mask name>.jpg;
    real_scores by real file name, fake_scores by mask file name."""
    for mask_fname in mask_fnames:
        real = draw_score(load_image(mask2real[mask_fname]),
                          real_scores[mask2real[mask_fname]])
        fake = draw_score(load_image(mask2fake[mask_fname]),
                          fake_scores[mask_fname])
        grid = np.concatenate([real, fake], axis=1)
        out_name = os.path.splitext(os.path.basename(mask_fname))[0] + '.jpg'
        cv2.imwrite(os.path.join(out_dir, out_name),
                    cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))


def mask_overlap(mask_a_fname, mask_b_fname):
    a = load_image(mask_a_fname, mode='L')[..., 0] > 0.5
    b = load_image(mask_b_fname, mode='L')[..., 0] > 0.5
    inter = (a & b).sum()
    return inter / max(min(a.sum(), b.sum()), 1)


def join_scores(orig_fnames, mask_fnames, mask2real, mask2fake, real_scores,
                fake_scores):
    """The JAX CLI's pandas tables by hand: (real score by real file name,
    first of each; the joined rows, de-duplicated on (fake_fname,
    real_fname), first kept)."""
    real_info = {}
    for fname, score in zip(orig_fnames, real_scores):
        real_info.setdefault(fname, float(score))
    rows, seen = [], set()
    for fname, score in zip(mask_fnames, fake_scores):
        key = (mask2fake[fname], mask2real[fname])
        if key in seen:
            continue
        seen.add(key)
        rows.append(dict(mask_fname=fname, fake_fname=key[0],
                         real_fname=key[1], fake_score=float(score),
                         real_score=real_info.get(key[1], float('nan'))))
    return real_info, rows


def features(dataset, device):
    """Inception features of each real image (once a file) and each fake;
    the file names and maps of the JAX CLI."""
    from .evaluation.fid import InceptionActivations
    inception = InceptionActivations.get(device=device)
    real2vec = {}
    real_features, fake_features = [], []
    orig_fnames, mask_fnames, mask2real, mask2fake = [], [], {}, {}
    for i in range(len(dataset)):
        batch = dataset[i]
        orig_fname = dataset.img_filenames[i]
        mask_fname = dataset.mask_filenames[i]
        mask2real[mask_fname] = orig_fname
        mask2fake[mask_fname] = dataset.pred_filenames[i]
        if orig_fname not in real2vec:
            real2vec[orig_fname] = inception(batch['image'][None])
        real_features.append(real2vec[orig_fname])
        fake_features.append(inception(batch['inpainted'][None]))
        orig_fnames.append(orig_fname)
        mask_fnames.append(mask_fname)
    return (real_features, fake_features, orig_fnames, mask_fnames,
            mask2real, mask2fake)


def main(args):
    from .evaluation.linear_svm import LinearSVC

    with open(args.config) as f:
        config = yaml.safe_load(f)
    latents_dir = os.path.join(args.outpath, 'latents')
    global_worst_dir = os.path.join(args.outpath, 'global_worst')
    global_best_dir = os.path.join(args.outpath, 'global_best')
    for d in (latents_dir, global_worst_dir, global_best_dir):
        os.makedirs(d, exist_ok=True)
    names = ('orig_fnames', 'mask_fnames', 'mask2real_fname',
             'mask2fake_fname', 'real_scores', 'fake_scores')

    if not args.only_report:
        from .data.datasets import PrecomputedInpaintingResultsDataset
        device = resolve_device(args.device or 'cuda')
        dataset = PrecomputedInpaintingResultsDataset(
            args.datadir, args.predictdir, **config.get('dataset_kwargs', {}))
        (real_features, fake_features, orig_fnames, mask_fnames, mask2real,
         mask2fake) = features(dataset, device)
        feats = np.concatenate(real_features + fake_features, axis=0)
        labels = np.array([1] * len(real_features) + [0] * len(fake_features))
        scores = LinearSVC().fit(feats, labels).decision_function(feats)
        real_scores = scores[:len(real_features)]
        fake_scores = scores[len(real_features):]
        for name, obj in zip(names, (orig_fnames, mask_fnames, mask2real,
                                     mask2fake, real_scores, fake_scores)):
            with open(os.path.join(latents_dir, f'{name}.pkl'), 'wb') as f:
                pickle.dump(obj, f, protocol=3)
    else:
        loaded = []
        for name in names:
            with open(os.path.join(latents_dir, f'{name}.pkl'), 'rb') as f:
                loaded.append(pickle.load(f))
        (orig_fnames, mask_fnames, mask2real, mask2fake, real_scores,
         fake_scores) = loaded

    real_info, rows = join_scores(orig_fnames, mask_fnames, mask2real,
                                  mask2fake, real_scores, fake_scores)
    with open(os.path.join(latents_dir, 'join_scores_table.csv'), 'w',
              newline='') as f:
        writer = csv.DictWriter(f, fieldnames=JOIN_COLUMNS, delimiter='\t')
        writer.writeheader()
        writer.writerows(rows)
    fake_by_mask = {r['mask_fname']: r['fake_score'] for r in rows}

    take_top = int(config.get('take_global_top', 30))
    ranked = sorted(rows, key=lambda r: r['fake_score'])
    worst = [r['mask_fname'] for r in ranked[:take_top]]
    best = [r['mask_fname'] for r in ranked[::-1][:take_top]]
    save_global_samples(worst, mask2real, mask2fake, global_worst_dir,
                        real_info, fake_by_mask)
    save_global_samples(best, mask2real, mask2fake, global_best_dir,
                        real_info, fake_by_mask)

    # overlapping-mask sensitivity (reference analyze_errors.py:85-101,
    # 283-300): score differences of strongly overlapping masks of one image
    by_real = {}
    for r in rows:
        by_real.setdefault(r['real_fname'], set()).add(r['mask_fname'])
    pairs, diffs = [], []
    for real_fname in sorted(by_real):
        group = sorted(by_real[real_fname])
        for i in range(len(group) - 1):
            for j in range(i + 1, len(group)):
                if mask_overlap(group[i], group[j]) > config.get('min_overlap',
                                                                 0.5):
                    pairs.append((group[i], group[j]))
                    diffs.append(abs(fake_by_mask[group[i]]
                                     - fake_by_mask[group[j]]))
    if pairs:
        with open(os.path.join(args.outpath,
                               'overlapping_mask_score_diffs.tsv'), 'w') as f:
            for k in np.argsort(diffs)[::-1]:
                f.write(f'{diffs[k]:.4f}\t{pairs[k][0]}\t{pairs[k][1]}\n')
    print(f'Analysis written to {args.outpath}')


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('config', help='e.g. configs/analyze_mask_errors.yaml')
    parser.add_argument('datadir')
    parser.add_argument('predictdir')
    parser.add_argument('outpath')
    parser.add_argument('--only-report', action='store_true')
    parser.add_argument('--device', default='cuda',
                        help='cuda (default) or cpu')
    return parser.parse_args(argv)


if __name__ == '__main__':
    main(parse_args())
