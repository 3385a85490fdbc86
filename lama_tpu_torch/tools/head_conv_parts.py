"""Time the head kernel with one of its parts switched off at a time.

    python -m lama_tpu_torch.tools.head_conv_parts [--tree DIR]

The head is kernel 5, csrc/reflect_conv.cu. From the tree (default: this
checkout) the tool writes one copy of lama_tpu_torch per entry of PARTS
under <tree>/_scratch/head_parts/ (git-ignored). Each copy adds one
runtime-false guard to the kernel: `nocopy` skips the halo copies,
`nomath` the mma or FFMA loop, `noepi` the epilogue. The full tree and the
copies then run in turns (full, nocopy, nomath, noepi, then reversed),
each in a fresh process that builds its own source. Each prints the
kernel's own device ms per call (torch.profiler over 10 calls) at the
served head, (16, 64, 512, 512) -> 3 with a bias on a channels-last input,
fp32 and bf16. The output of a copy with a part switched off is
meaningless and is not checked: what counts is the time the rest takes.
tests/test_torch_cuda.py and chip_smoke.py check the full kernel. Needs a
CUDA card and nvcc.
"""
import argparse
import json
import os
import shutil
import sys

if __package__ in (None, ''):   # run as a script by in_turns' workers
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fourier_unit_time import device_ms, in_turns
else:
    from .fourier_unit_time import device_ms, in_turns

SOURCE = os.path.join('lama_tpu_torch', 'csrc', 'reflect_conv.cu')
PARTS = {   # name: [(text of csrc/reflect_conv.cu, its replacement)]
    'nocopy': [('    const T* xb = x + size_t(b) * H * W * C;\n',
                '    if (B > 0) return;\n'
                '    const T* xb = x + size_t(b) * H * W * C;\n')],
    'nomath': [('    if constexpr (PL::BF16)\n      mma_chunk<CO>(',
                '    if constexpr (PL::BF16)\n      if (C < 0) mma_chunk<CO>('),
               ('    if constexpr (!PL::BF16)\n      fma_chunk<CO>(',
                '    if constexpr (!PL::BF16)\n      if (C < 0) fma_chunk<CO>(')],
    'noepi': [('    if (k != chunks - 1) continue;',
               '    if (k != chunks - 1 || C > 0) continue;')],
}
SHAPE, C_OUT = (16, 64, 512, 512), 3


def part_source(text, name):
    """The kernel's source `text` with part `name` switched off."""
    for old, new in PARTS[name]:
        if text.count(old) != 1:
            raise ValueError(f'head_conv_parts: {name}: {old!r} is not in '
                             'the source exactly once')
        text = text.replace(old, new)
    return text


def make_copies(tree):
    """One copy of the tree's lama_tpu_torch per part, under
    <tree>/_scratch/head_parts/<name>; returns their roots."""
    with open(os.path.join(tree, SOURCE)) as f:
        text = f.read()
    roots = []
    for name in PARTS:
        root = os.path.join(tree, '_scratch', 'head_parts', name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(os.path.join(tree, 'lama_tpu_torch'),
                        os.path.join(root, 'lama_tpu_torch'),
                        ignore=shutil.ignore_patterns('_build', '__pycache__'))
        with open(os.path.join(root, SOURCE), 'w') as f:
            f.write(part_source(text, name))
        roots.append(root)
    return roots


def _worker(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from lama_tpu_torch.ops.kernels import reflect_conv as rc
    gen = torch.Generator().manual_seed(0)
    b, c, h, w = SHAPE
    x = torch.rand(b, c, h, w, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    wt = ((torch.rand(C_OUT, c, 7, 7, generator=gen) * 2 - 1)
          * (c * 49) ** -0.5).cuda()
    bias = torch.rand(C_OUT, generator=gen).cuda()
    res = {}
    for name, dt in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        xt = x.to(dt)
        with torch.no_grad():
            res[name] = device_ms(lambda: rc.reflect_out_conv7x7(xt, wt, bias),
                                  calls=10)
    print(json.dumps(res), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--tree', default='.')
    parser.add_argument('--worker', help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        _worker(args.worker)
        return 0
    trees = [args.tree] + make_copies(args.tree)
    names = ['full'] + list(PARTS)
    label = dict(zip(trees, names))
    runs = {}
    for tree, res in in_turns(__file__, trees, []):
        print(f'{label[tree]}: device ms {json.dumps(res)}', flush=True)
        for dtype, ms in res.items():
            runs.setdefault((label[tree], dtype), []).append(ms)
    for (name, dtype), v in runs.items():
        if None not in v:
            print(f'{name} {dtype}: {sum(v) / len(v):.4f} ms (mean of '
                  f'{len(v)})', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
