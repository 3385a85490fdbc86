"""Time the host-paced paths of one or more source trees on one card, the
trees in turns: big-lama's eager serving (bf16 and int8) and refine, and
its bf16 train step; big-lama-regular's serving.

    python -m lama_tpu_torch.tools.serve_time [--tree DIR ...] [--refine N]
        [--rounds R] [--train-steps N]

Each tree is the root of a checkout of this repository (default: this
one); with two trees or more, e.g. a `git archive` of the parent commit
unpacked into a git-ignored directory and `.`, they run in the order a,
b, .., b, a, R times, each in a fresh process that imports that tree's
lama_tpu_torch (and builds its kernels unless its `_build` already holds
them). In each, on the card, at 512^2 through serving.make_inpaint_forward
(CUDA events, median of 10 after 3 warm-up):
- big-lama (configs/training/big-lama.yaml's generator, torch's init from
  seed 0) in bf16: img/s of a b16 forward and ms of a b1 forward;
- the same weights in int8's headline mode (int8, quant_zero_pad,
  spectral_bf16_store, s2d_out_head; static scales calibrated on the
  batch): img/s at b16;
- big-lama-regular (seed 0) in bf16 and in int8's headline mode: img/s at
  b16;
- `refine_predict` (the predict CLI's refiner options) on a 1000 x 760
  image with a 300 x 400 hole: seconds, the mean of N after one warm-up;
- big-lama's bf16 train step (configs/training/big-lama.yaml, batch 10 at
  256^2, random ResNet-PL weights): ms a step, the median of N after 3
  warm-up, the device synchronised around each.
The b1 forward, the refiner and the bf16 train step are paced by the
host, so they show what each kernel call costs there (the registered-op
dispatch of ops/kernels/library.py, where the tree has it). Prints the
card's name and power limit, one line per process and, with two trees,
each metric's mean and its spread (min, max) per tree. Needs a CUDA card
and nvcc.
"""
import argparse
import json
import os
import sys
import tempfile
import time

if __package__ in (None, ''):   # run as a script by in_turns' workers
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fourier_unit_time import in_turns
else:
    from .fourier_unit_time import in_turns

REFINE_SIZE = (1000, 760)
TRAIN_BATCH, TRAIN_SIZE = 10, 256


def _events_ms(fn, iters=10, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _batch(b):
    import torch
    image = torch.rand(b, 512, 512, 3, device='cuda')
    mask = torch.zeros(b, 512, 512, 1, device='cuda')
    mask[:, 128:320, 160:384] = 1
    return image, mask


def _generator(tree, config, int8=False):
    """The config's generator, torch's init from seed 0, in bf16 compute
    (int8's headline mode with int8) on the card."""
    import torch
    from lama_tpu_torch.models import make_generator
    from lama_tpu_torch.ops.serving_mode import ServingMode
    from lama_tpu_torch.serving import generator_config
    kw = generator_config(os.path.join(tree, 'configs', 'training',
                                       config + '.yaml'))
    if int8:
        kw['serving_mode'] = ServingMode(int8=True, zero_pad=True,
                                         spectral_bf16_store=True,
                                         s2d='out_head')
    torch.manual_seed(0)
    gen = make_generator(kw.pop('kind'), dtype=torch.bfloat16, **kw)
    return gen.to('cuda').eval().requires_grad_(False)


def _serve_b16(tree, config, int8, row, name):
    """row[name + 'b16_img_s']: img/s of the config's b16 forward; returns
    the generator and its serving forward."""
    from lama_tpu_torch.serving import calibrate_int8, make_inpaint_forward
    gen = _generator(tree, config, int8)
    image, mask = _batch(16)
    if int8:
        calibrate_int8(gen, [(image, mask)])
    forward = make_inpaint_forward(gen)
    row[name + 'b16_img_s'] = 16e3 / _events_ms(lambda: forward(image, mask))
    return gen, forward


def _refine_s(tree, gen, n):
    import numpy as np
    import torch
    from lama_tpu_torch.config import compose
    from lama_tpu_torch.evaluation.refinement import refine_predict
    cfg = compose(os.path.join(tree, 'configs', 'prediction'), 'default', [])
    h, w = REFINE_SIZE
    rng = np.random.RandomState(0)
    image = rng.rand(1, h, w, 3).astype(np.float32)
    mask = np.zeros((1, h, w, 1), np.float32)
    mask[:, 300:600, 200:600] = 1
    secs = []
    for i in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refine_predict(image, mask, gen, **dict(cfg.refiner))
        torch.cuda.synchronize()
        if i:
            secs.append(time.perf_counter() - t0)
    return sum(secs) / len(secs)


def _train_step_ms(tree, n):
    """Median ms of big-lama's bf16 train step (InpaintingTrainStep, G and
    D with their optimizers) on one random batch."""
    import torch
    from lama_tpu_torch.config import compose
    from lama_tpu_torch.training.trainer import InpaintingTrainer
    with tempfile.TemporaryDirectory() as work:
        config = compose(os.path.join(tree, 'configs', 'training'),
                         'big-lama', [
                             f'location.out_root_dir={work}',
                             f'location.tb_dir={work}',
                             f'location.pretrained_models={work}',
                             f'data.batch_size={TRAIN_BATCH}',
                             'trainer.kwargs.precision=bf16',
                             'losses.resnet_pl.allow_random_weights=true'])
        trainer = InpaintingTrainer(config, os.path.join(work, 'run'),
                                    device='cuda')
        g = torch.Generator().manual_seed(0)
        shape = (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE)
        image = torch.rand(*shape, 3, generator=g).cuda().movedim(-1, -3)
        mask = torch.zeros(*shape, 1)
        mask[:, 64:192, 32:160] = 1
        mask = mask.cuda().movedim(-1, -3)
        times = []
        for i in range(n + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.step_fn(trainer.state, image, mask)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        del trainer
    return sorted(times)[len(times) // 2]


def _worker(tree, refine_n, train_n):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    row = {}
    gen, forward = _serve_b16(tree, 'big-lama', False, row, '')
    image, mask = _batch(1)
    row['b1_ms'] = _events_ms(lambda: forward(image, mask))
    row['refine_s'] = _refine_s(tree, gen, refine_n)
    del gen, forward
    for config, int8, name in (('big-lama', True, 'int8_'),
                               ('big-lama-regular', False, 'regular_'),
                               ('big-lama-regular', True, 'regular_int8_')):
        _serve_b16(tree, config, int8, row, name)
    torch.cuda.empty_cache()
    if train_n:
        row['train_bf16_ms'] = _train_step_ms(tree, train_n)
    print(json.dumps(row), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--tree', action='append', default=[])
    parser.add_argument('--refine', type=int, default=2,
                        help='timed refine_predict calls a process')
    parser.add_argument('--rounds', type=int, default=1,
                        help='times the order a, b, .., b, a is run')
    parser.add_argument('--train-steps', type=int, default=10,
                        help='timed bf16 train steps a process (0: none)')
    parser.add_argument('--worker', help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        _worker(args.worker, args.refine, args.train_steps)
        return 0
    trees = args.tree or ['.']
    results = {}
    for _ in range(args.rounds):
        for tree, row in in_turns(__file__, trees, [
                '--refine', str(args.refine),
                '--train-steps', str(args.train_steps)]):
            print(f'{tree}: ' + ', '.join(f'{k} {v:.3f}'
                                          for k, v in row.items()),
                  flush=True)
            for k, v in row.items():
                results.setdefault(k, {}).setdefault(tree, []).append(v)
    if len(trees) > 1:
        for k, per in results.items():
            print(f'mean {k}: ' + ', '.join(
                f'{t} {sum(v) / len(v):.3f} ({min(v):.3f}, {max(v):.3f}; '
                f'n {len(v)})' for t, v in per.items()), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
