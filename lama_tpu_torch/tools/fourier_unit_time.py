"""Time the FourierUnit kernel (kernel 1) of one or more source trees on one
card, in turns.

    python -m lama_tpu_torch.tools.fourier_unit_time [--tree DIR ...]
        [--shapes fu,fu_b16,...]

Each tree is the root of a checkout of this repository (default: this
one); `--tree` given twice or more, e.g. a `git archive` of the parent
commit unpacked into a git-ignored directory and `.`, times them in the
order a, b, .., b, a, each in a fresh process that imports that tree's
lama_tpu_torch (and so builds that tree's csrc/fourier_unit.cu). In each,
at the served shapes (batch 4 and batch 16 at 64 x 64, C = C' = 192) and
the refine shapes (batch 1 at 128 x 128, 125 x 95 and 63 x 48), fp32 and
bf16 input (and bf16 with store_bf16, where the tree's unit takes it): the
output is held to the plain fp32 unit (fp32 rtol/atol 1e-4, bf16 2e-2),
then the wrapper's median ms per call (CUDA events, 10
calls after 3 warm-up), the kernel's own device ms per call
(torch.profiler over 5 calls: the kernels of csrc/, in anonymous
namespaces) and, where the tree's wrapper launches through `_gemm`, each
stage's device ms (CUDA events around each launch, median of 10 units).
Prints one line per tree, shape and dtype and, with two trees, the
per-shape ratio of their device times. `--shapes` keeps only the named
shapes (the keys of SHAPES). Needs a CUDA card and nvcc.
"""
import argparse
import inspect
import json
import os
import subprocess
import sys

SHAPES = {'fu': (4, 64, 64), 'fu_b16': (16, 64, 64),
          'refine_fu_1024': (1, 128, 128), 'refine_fu': (1, 125, 95),
          'refine_fu_s1': (1, 63, 48)}
CHANNELS = 192
TOL = {'fp32': 1e-4, 'bf16': 2e-2, 'bf16_store': 2e-2}


def events_ms(fn, iters=10, warmup=3):
    """Median ms of fn per call on the card: CUDA events around each of
    `iters` calls after `warmup`."""
    import numpy as np
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
    return float(np.median(times))


def device_ms(fn, calls=5):
    """Device ms per call of fn in the port's own kernels (csrc/, in
    anonymous namespaces) under torch.profiler; None when the trace shows
    none of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    own = [e.self_device_time_total for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and '(anonymous namespace)::' in e.key and 'at::' not in e.key]
    return sum(own) / calls / 1e3 if own else None


def dev_text(ms):
    return 'not measured' if ms is None else f'{ms:.4f} ms'


def _worker(tree, shapes):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from lama_tpu_torch.ops.kernels import fourier_unit as fu
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    c = CHANNELS

    def u(*shape, scale=1.0, shift=0.0):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale
                + shift).cuda()

    def stage_ms(fn, iters=10):
        if not hasattr(fu, '_gemm'):
            return None
        events, saved = [], fu._gemm

        def timed(stage, *args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            saved(stage, *args)
            b.record()
            events.append((stage, a, b))

        fu._gemm = timed
        try:
            fn()
            torch.cuda.synchronize()
            events.clear()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        finally:
            fu._gemm = saved
        per = {}
        for stage, a, b in events:
            per.setdefault(stage, []).append(a.elapsed_time(b))
        return {k: float(np.median(v)) for k, v in per.items()}

    # a tree whose unit takes store_bf16 also times it on the bf16 input
    store = 'store_bf16' in inspect.signature(fu.fused_fourier_unit).parameters
    rows = []
    for role in shapes:
        b, h, w = SHAPES[role]
        args = ((u(b, c, h, w) + 1) / 2, u(2 * c, 2 * c, 1, 1, scale=0.05),
                u(2 * c, scale=0.2, shift=1.0), u(2 * c, scale=0.1),
                u(2 * c, scale=0.1), u(2 * c, scale=0.3, shift=1.0))
        ref = fu.fourier_unit_plain(*args)
        cases = [('fp32', torch.float32, {}), ('bf16', torch.bfloat16, {})]
        if store:
            cases.append(('bf16_store', torch.bfloat16,
                          dict(store_bf16=True)))
        for dtype, tdt, kw in cases:
            kargs = (args[0].to(tdt),) + args[1:]
            with torch.no_grad():
                out = fu.fused_fourier_unit(*kargs, **kw).float()
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                tol = TOL[dtype]
                ok = bool(torch.all((out - ref).abs() <= tol + tol * ref.abs()))

                def call():
                    fu.fused_fourier_unit(*kargs, **kw)
                rows.append(dict(role=role, shape=[b, c, h, w], dtype=dtype,
                                 max_abs_err=err, within_tol=ok,
                                 ms=events_ms(call), dev_ms=device_ms(call),
                                 stages=stage_ms(call)))
    print(json.dumps(rows), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--tree', action='append', default=[])
    parser.add_argument('--shapes', default=','.join(SHAPES))
    parser.add_argument('--worker', help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    shapes = args.shapes.split(',')
    if not set(shapes) <= set(SHAPES):
        parser.error(f'--shapes: one of {", ".join(SHAPES)}')
    if args.worker:
        _worker(args.worker, shapes)
        return 0
    trees = args.tree or ['.']
    results = {}
    for tree, rows in in_turns(__file__, trees, ['--shapes', args.shapes]):
        for r in rows:
            stages = ('' if r['stages'] is None else ' stages ' + ', '.join(
                f'{k} {v:.4f}' for k, v in r['stages'].items()))
            print(f'{tree} {r["role"]} {r["dtype"]} {r["shape"]}: max|d| '
                  f'{r["max_abs_err"]:.2e} (within tol: {r["within_tol"]}) '
                  f'wrapper {r["ms"]:.4f} ms dev {dev_text(r["dev_ms"])}'
                  f'{stages}', flush=True)
            if r['dev_ms'] is not None:
                results.setdefault((r['role'], r['dtype']), {}).setdefault(
                    tree, []).append(r['dev_ms'])
        if not all(r['within_tol'] for r in rows):
            raise RuntimeError(f'fourier_unit_time: tree {tree} outside '
                               'tolerance')
    print_ratios(trees, results)
    return 0


def in_turns(script, trees, worker_args):
    """Print the card's name and power limit, then run `script --worker
    <tree> *worker_args` for each tree in the order a, b, .., b, a (one
    tree: once), each in a fresh process that imports that tree's
    lama_tpu_torch; yields (tree, the JSON rows its last line prints)."""
    order = trees + trees[::-1] if len(trees) > 1 else trees
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for tree in order:
        # run as a script, so that the worker imports that tree's package
        proc = subprocess.run([sys.executable, os.path.abspath(script),
                               '--worker', os.path.abspath(tree),
                               *worker_args], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f'{script}: tree {tree} failed')
        yield tree, json.loads(proc.stdout.strip().splitlines()[-1])


def print_ratios(trees, results):
    """With two trees or more: each (role, dtype)'s mean device ms per tree
    and its ratio to the first tree's that has the row; results[(role, dtype)][tree] is the
    list of that tree's readings."""
    if len(trees) < 2:
        return
    for (role, dtype), per in results.items():
        # the first tree that timed this row (an older tree may lack it)
        base = next(t for t in trees if t in per)
        mean = {t: sum(v) / len(v) for t, v in per.items()}
        print(f'dev {role} {dtype}: ' + ', '.join(
            f'{t} {m:.4f} ms ({mean[base] / m:.2f}x of {base})'
            for t, m in mean.items()), flush=True)


if __name__ == '__main__':
    sys.exit(main())
