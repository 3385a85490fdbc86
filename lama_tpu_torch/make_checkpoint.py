"""Checkpoint surgery for deployment: `python -m lama_tpu_torch.make_checkpoint`,
the counterpart of bin/make_checkpoint.py (reference bin/make_checkpoint.py).

Usage:
  python -m lama_tpu_torch.make_checkpoint <indir> [<outdir>] \
      [--epochs 38 39 40] [--no-ema] [--repair-index]

<indir> is a run dir of `python -m lama_tpu_torch.train`: config.yaml and
models/ with epoch<N>.ckpt, index.json (the top-k records by the monitor)
and last.ckpt (training/checkpoint.py). The CLI takes the best record by
the monitor, or with --epochs averages those epochs tensor-wise (integer
buffers, such as BatchNorm's num_batches_tracked, from the first), keeps
the generator only (the EMA weights `generator_average.*` in place of the
parameters unless --no-ema; the discriminator and the optimizer states are
dropped), and writes <outdir>/models/best.ckpt as {'state_dict':
{'generator.*': ...}}, which convert.py::load_checkpoint and so the predict
CLI read, with config.yaml copied beside it. A generator tensor that is
not finite fails the run before anything is written: the trainer saves
its epochs whatever their weights hold (trainer.kwargs.terminate_on_nan is
off by default), so a run that diverged leaves NaN weights, and its EMA
with them, in every later epoch. --repair-index first repairs
models/index.json in place (CheckpointManager.repair_index: records whose
checkpoint file is gone are dropped, values outside the monitor's valid
range demoted to strictly worst); outdir is then optional. Runs on the
host: no device is needed.
"""
import argparse
import json
import os
import shutil

import torch

from .config import load_yaml
from .training.checkpoint import CheckpointManager

DEFAULT_MONITOR = 'val_ssim_fid100_f1_total_mean'


def generator_state(ckpt: dict, ema: bool = True) -> dict:
    """The generator's entries of a trainer checkpoint, 'generator.*',
    with the EMA copies ('generator_average.<param>') in place of the
    parameters when `ema` and the checkpoint has them."""
    sd = ckpt['state_dict']
    out = {k: v for k, v in sd.items() if k.startswith('generator.')}
    if ema:
        for k, v in sd.items():
            if k.startswith('generator_average.'):
                out['generator.' + k[len('generator_average.'):]] = v
    return out


def average(states):
    """Tensor-wise mean of state dicts with the same keys; integer tensors
    (counters, not weights) are taken from the first."""
    first = states[0]
    out = {}
    for k, v in first.items():
        if v.is_floating_point():
            out[k] = torch.stack([s[k].float() for s in states]).mean(
                0).to(v.dtype)
        else:
            out[k] = v
    return out


def non_finite(state) -> list:
    """The keys of the floating tensors of `state` that hold a NaN or an
    infinity."""
    return [k for k, v in state.items()
            if v.is_floating_point() and not bool(torch.isfinite(v).all())]


def main(args):
    models_dir = os.path.join(args.indir, 'models')
    if args.repair_index:
        monitor = DEFAULT_MONITOR
        cfg_path = os.path.join(args.indir, 'config.yaml')
        if os.path.exists(cfg_path):
            monitor = str(load_yaml(cfg_path).select(
                'trainer.checkpoint_kwargs.monitor', monitor))
        summary = CheckpointManager.repair_index(models_dir, monitor=monitor)
        print(f'Repaired {models_dir}/index.json (monitor={monitor}): '
              f'{summary}')
        if args.outdir is None:
            return
    if args.outdir is None:
        raise SystemExit('outdir required unless --repair-index only')
    if args.epochs:
        names = [f'epoch{e}.ckpt' for e in args.epochs]
    else:
        with open(os.path.join(models_dir, 'index.json')) as f:
            records = json.load(f)
        names = [sorted(records, key=lambda r: r['value'],
                        reverse=True)[0]['name']]
    states = [generator_state(
        torch.load(os.path.join(models_dir, n), map_location='cpu',
                   weights_only=True), ema=not args.no_ema) for n in names]
    merged = states[0] if len(states) == 1 else average(states)
    bad = non_finite(merged)
    if bad:
        raise ValueError(
            f'{names}: {len(bad)} generator tensor(s) hold NaN or inf '
            f'({", ".join(bad[:4])}{", ..." if len(bad) > 4 else ""}): the '
            'run diverged by then; pick earlier --epochs')

    out_models = os.path.join(args.outdir, 'models')
    os.makedirs(out_models, exist_ok=True)
    torch.save({'state_dict': merged}, os.path.join(out_models, 'best.ckpt'))
    shutil.copy(os.path.join(args.indir, 'config.yaml'),
                os.path.join(args.outdir, 'config.yaml'))
    print(f'Exported {names} -> {out_models}/best.ckpt')


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('indir')
    parser.add_argument('outdir', nargs='?', default=None)
    parser.add_argument('--epochs', nargs='*', type=int, default=None,
                        help='epoch numbers to average (default: best by '
                             'monitor)')
    parser.add_argument('--no-ema', action='store_true',
                        help='use raw generator weights instead of EMA')
    parser.add_argument('--repair-index', action='store_true',
                        help='repair models/index.json first: drop records '
                             'for deleted checkpoints, demote non-finite / '
                             'out-of-range monitor values to strictly-worst')
    return parser.parse_args(argv)


if __name__ == '__main__':
    main(parse_args())
