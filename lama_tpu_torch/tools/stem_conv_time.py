"""Time the 7x7 stem and head of one or more source trees on one card.

The stem is kernel 7 at 7x7, stride 1, 4 -> 64; the head is kernel 5,
64 -> 3. The trees run in turns.

    python -m lama_tpu_torch.tools.stem_conv_time [--tree DIR ...]
        [--shapes stem,stem_b16,head_b16,...]

Each tree is the root of a checkout of this repository (default: this
one); with two trees or more, e.g. a `git archive` of the parent commit
unpacked into a git-ignored directory and `.`, they run in the order a,
b, .., b, a, each in a fresh process that imports that tree's
lama_tpu_torch (and so builds that tree's kernels). In each, at the
shapes of the serve (batch 4 and 16 at 512^2), train (batch 10 at 256^2)
and refine (batch 1 at 1024^2 and 1000 x 760) paths, fp32 and bf16, with
a bias: the output of the wrapper (`halo_conv_reflect_tiled` for the
stem on an NCHW input, `reflect_out_conv7x7` for the head on a
channels-last input, the layout the generator hands it) is held to the
plain fp32 conv (fp32 rtol/atol 1e-4, bf16 2e-2), then the wrapper's
median ms per call (CUDA events, 10 calls after 3 warm-up), the kernel's
own device ms per call (torch.profiler over 5 calls: the kernels of
csrc/, in anonymous namespaces) and the library call's median ms
(nn.Conv2d(padding_mode='reflect') on the same input and dtype). Prints
one line per tree, shape and dtype and, with two trees, the per-shape
ratio of their device times. `--shapes` keeps only the named shapes (the
keys of SHAPES; default all). Needs a CUDA card and nvcc.
"""
import argparse
import json
import os
import sys

if __package__ in (None, ''):   # run as a script by in_turns' workers
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fourier_unit_time import (dev_text, device_ms, events_ms, in_turns,
                                   print_ratios)
else:
    from .fourier_unit_time import (dev_text, device_ms, events_ms, in_turns,
                                    print_ratios)

# role: (conv, batch, H, W); conv: (C, C_out, NCHW or channels-last input)
SHAPES = {'stem': ('stem', 4, 512, 512), 'stem_b16': ('stem', 16, 512, 512),
          'train_stem': ('stem', 10, 256, 256),
          'refine_stem_1024': ('stem', 1, 1024, 1024),
          'refine_stem': ('stem', 1, 1000, 760),
          'head': ('head', 4, 512, 512), 'head_b16': ('head', 16, 512, 512),
          'train_head': ('head', 10, 256, 256),
          'refine_head_1024': ('head', 1, 1024, 1024),
          'refine_head': ('head', 1, 1000, 760)}
CONVS = {'stem': (4, 64, 'nchw'),
         'head': (64, 3, 'channels_last')}
TOL = {'fp32': 1e-4, 'bf16': 2e-2}


def _worker(tree, shapes):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    from lama_tpu_torch.ops.kernels import reflect_conv as rc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    wrappers = {'stem': hc.halo_conv_reflect_tiled,
                'head': rc.reflect_out_conv7x7}

    rows = []
    for role in shapes:
        conv, b, h, w = SHAPES[role]
        c, c_out, layout = CONVS[conv]
        fn = wrappers[conv]
        x = torch.rand(b, c, h, w, generator=gen).cuda()
        if layout == 'channels_last':
            x = x.contiguous(memory_format=torch.channels_last)
        wt = ((torch.rand(c_out, c, 7, 7, generator=gen) * 2 - 1)
              * (c * 49) ** -0.5).cuda()
        bias = ((torch.rand(c_out, generator=gen) * 2 - 1) * 0.1).cuda()
        ref = rc.reflect_conv_plain(x, wt, bias)
        for dtype, tdt in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
            xt = x.to(tdt)
            lib = torch.nn.Conv2d(c, c_out, 7, padding=3,
                                  padding_mode='reflect')
            with torch.no_grad():
                lib.weight.copy_(wt)
                lib.bias.copy_(bias)
                lib = lib.to(device=x.device, dtype=tdt)
                out = fn(xt, wt, bias).float()
                torch.cuda.synchronize()
                err = (out - ref).abs()
                tol = TOL[dtype]
                ok = bool(torch.all(err <= tol + tol * ref.abs()))
                del out

                def call():
                    fn(xt, wt, bias)
                rows.append(dict(role=role, shape=[b, c, h, w], dtype=dtype,
                                 max_abs_err=float(err.max()), within_tol=ok,
                                 ms=events_ms(call), dev_ms=device_ms(call),
                                 library_ms=events_ms(lambda: lib(xt))))
                del err, xt
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
            print(f'{tree} {r["role"]} {r["dtype"]} {r["shape"]}: max|d| '
                  f'{r["max_abs_err"]:.2e} (within tol: {r["within_tol"]}) '
                  f'wrapper {r["ms"]:.4f} ms dev {dev_text(r["dev_ms"])} '
                  f'library {r["library_ms"]:.4f} ms', flush=True)
            if r['dev_ms'] is not None:
                results.setdefault((r['role'], r['dtype']), {}).setdefault(
                    tree, []).append(r['dev_ms'])
        if not all(r['within_tol'] for r in rows):
            raise RuntimeError(f'stem_conv_time: tree {tree} outside '
                               'tolerance')
    print_ratios(trees, results)
    return 0


if __name__ == '__main__':
    sys.exit(main())
