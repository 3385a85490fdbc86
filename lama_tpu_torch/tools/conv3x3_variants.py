"""Time variants of a 3x3 reflect-conv kernel's constants on one card.

    python -m lama_tpu_torch.tools.conv3x3_variants [wgmma|simt ...]

`wgmma`: csrc/conv3x3_wgmma.cu (bf16); `simt`: csrc/conv3x3_simt.cu
(fp32); both when no source is named. Each variant is the source with some
of its constants replaced (VARIANTS below). All are built with the port's
nvcc flags into lama_tpu_torch/_build/variants/ and launched through their
extern "C" launchers on channels-last inputs with the weights packed once,
so a time is the kernel alone: CUDA events around 20 back-to-back launches,
after 3 warm-up launches, each variant twice in turns (a, b, ..., b, a), at
big-lama's served shapes (batch 16: the four downsamples at stride 2, l2l,
l2g, g2l, and big-lama-regular's 512 -> 512 block) and a few smaller ones;
for `simt` also kernels 2 and 3's train (b10 32^2) and refine (batch 1,
125x95 and 63x48) shapes. Where conv3x3_simt.plan_splits splits a
stride-1 shape's K on this card, each variant runs there twice, at the
plan's split count and unsplit, in the same turns, printed as `split` and
`nosplit`. Each output is first held to the plain fp32 conv (bf16: max |d|
< 5e-2; fp32: within rtol and atol 1e-4). Prints each variant's ptxas
lines, then per shape the bound (bytes at 3.35 TB/s or FLOP at 989
TFLOP/s bf16, 67 fp32, the larger) and each variant's ms and share of it.
Needs a CUDA card and nvcc; imports nothing at module level beyond torch.
"""
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops.kernels import _build
from ..ops.kernels import conv3x3_simt as sm
from ..ops.kernels import conv3x3_wgmma as wg
from ..ops.kernels.reflect_conv import reflect_conv_plain

VARIANTS = {
    'wgmma': {
        'base': [],
        # stride 2 with two stages instead of three
        's2_ring2': [('constexpr int S2_STAGES = 3;',
                      'constexpr int S2_STAGES = 2;')],
        # stride 1 with stride 2's 16-channel stages, three or four of them
        's1_c16_ring3': [
            ('CHUNK = S == 1 ? CHUNK_C : S2_CHUNK_C',
             'CHUNK = S == 1 ? 16 : S2_CHUNK_C'),
            ('RING = S == 1 ? STAGES : S2_STAGES',
             'RING = S == 1 ? 3 : S2_STAGES')],
        's1_c16_ring4': [
            ('CHUNK = S == 1 ? CHUNK_C : S2_CHUNK_C',
             'CHUNK = S == 1 ? 16 : S2_CHUNK_C'),
            ('RING = S == 1 ? STAGES : S2_STAGES',
             'RING = S == 1 ? 4 : S2_STAGES')],
    },
    'simt': {
        'base': [],
        # stride 1 on two 16-channel stages, or three 8-channel ones
        's1_c16_ring2': [('int CHUNK_C = 8;', 'int CHUNK_C = 16;'),
                         ('int STAGES = 4;', 'int STAGES = 2;')],
        's1_c8_ring3': [('int STAGES = 4;', 'int STAGES = 3;')],
        # stride 2 with two stages instead of three
        's2_ring2': [('S2_STAGES = 3;', 'S2_STAGES = 2;')],
        # a 16 x 8 output tile (the same 16 pixel groups)
        'tile16x8': [('TILE_H = 8, TILE_W = 16;', 'TILE_H = 16, TILE_W = 8;')],
        # the tap loop not unrolled (base: all nine taps)
        'unroll1': [('TAP_UNROLL = 9;', 'TAP_UNROLL = 1;')],
    },
}
SHAPES = {  # role, stride, batch, C, C_out, (H, W) of the input
    'wgmma': [
        ('down1_b16', 2, 16, 64, 128, (512, 512)),
        ('down2_b16', 2, 16, 128, 256, (256, 256)),
        ('down3_l2l_b16', 2, 16, 256, 128, (128, 128)),
        ('down3_l2g_b16', 2, 16, 256, 384, (128, 128)),
        ('down1_b4', 2, 4, 64, 128, (512, 512)),
        ('down2_b4', 2, 4, 128, 256, (256, 256)),
        ('l2l_b16', 1, 16, 128, 128, (64, 64)),
        ('l2g_b16', 1, 16, 128, 384, (64, 64)),
        ('g2l_b16', 1, 16, 384, 128, (64, 64)),
        ('block_b16', 1, 16, 512, 512, (64, 64)),
        ('l2l_b4', 1, 4, 128, 128, (64, 64)),
        ('refine_l2l', 1, 1, 128, 128, (125, 95)),
    ],
    'simt': [
        ('down1_b16', 2, 16, 64, 128, (512, 512)),
        ('down2_b16', 2, 16, 128, 256, (256, 256)),
        ('down3_l2l_b16', 2, 16, 256, 128, (128, 128)),
        ('down3_l2g_b16', 2, 16, 256, 384, (128, 128)),
        ('down2_b4', 2, 4, 128, 256, (256, 256)),
        ('block_b16', 1, 16, 512, 512, (64, 64)),
        ('block_b4', 1, 4, 512, 512, (64, 64)),
        ('train_block', 1, 10, 512, 512, (32, 32)),
        # kernels 2 and 3 in fp32: served, trained (b10 32^2) and refined
        # (batch 1 at the 1000x760 image's 125x95 and 63x48 bottlenecks)
        ('l2l_b16', 1, 16, 128, 128, (64, 64)),
        ('l2g_b16', 1, 16, 128, 384, (64, 64)),
        ('g2l_b16', 1, 16, 384, 128, (64, 64)),
        ('train_l2l', 1, 10, 128, 128, (32, 32)),
        ('train_g2l', 1, 10, 384, 128, (32, 32)),
        ('refine_l2l', 1, 1, 128, 128, (125, 95)),
        ('refine_g2l', 1, 1, 384, 128, (125, 95)),
        ('refine_s1_l2l', 1, 1, 128, 128, (63, 48)),
        ('refine_s1_l2g', 1, 1, 128, 384, (63, 48)),
        ('refine_s1_g2l', 1, 1, 384, 128, (63, 48)),
    ],
}
KERNELS = {  # source: (wrapper module, dtype, peak FLOP/s, tolerance)
    'wgmma': (wg, torch.bfloat16, 989e12, (0.0, 5e-2)),
    'simt': (sm, torch.float32, 67e12, (1e-4, 1e-4)),
}
ARGTYPES = {  # the launchers' ctypes signatures
    'wgmma': [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    'simt': sm.ARGTYPES,
}


def pack(source, text, weight, stride):
    """The weight packed for one variant (its source `text`): simt packs in
    the variant's own chunk of input channels."""
    if source == 'wgmma':
        return wg.pack_conv3x3_weight(weight)
    name = 'CHUNK_C' if stride == 1 else 'S2_CHUNK_C'
    ck = int(re.search(rf'\b{name} = (\d+)', text).group(1))
    return sm.pack_conv3x3_weight(weight, stride, ck)
OUT_DIR = os.path.join(_build.BUILD_DIR, 'variants')


def build(source):
    """Write and compile every variant of `source` (one nvcc each, all at
    once); returns (the loaded library, the source text) by name."""
    src = open(_build.source_path('conv3x3_' + source)).read()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS[source].items():
        text = src
        for old, new in subs:
            assert old in text, (name, old)
            text = text.replace(old, new)
        cu = os.path.join(OUT_DIR, f'{source}_{name}.cu')
        with open(cu, 'w') as f:
            f.write(text)
        procs[name] = (cu, text, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, '-o', cu[:-3] + '.so', cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (cu, text, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {source} {name}:\n{log}')
        print(source, name, [ln.strip() for ln in log.splitlines()
                             if 'registers' in ln or 'spill' in ln], flush=True)
        lib = ctypes.CDLL(cu[:-3] + '.so')
        for symbol in KERNELS[source][0].LAUNCHERS.values():
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = ARGTYPES[source]
        libs[name] = (lib, text)
    return libs


def time_source(source):
    mod, dtype, peak, (rtol, atol) = KERNELS[source]
    variants = list(VARIANTS[source])
    libs = build(source)
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    size = torch.tensor([], dtype=dtype).element_size()
    for role, s, b, c, co, (h, w) in SHAPES[source]:
        x = torch.rand(b, c, h, w, generator=g).cuda()
        wt = ((torch.rand(co, c, 3, 3, generator=g) * 2 - 1)
              * (9 * c) ** -0.5).cuda()
        ref = reflect_conv_plain(x, wt, None, s)
        xk = x.to(dtype).contiguous(memory_format=torch.channels_last)
        del x
        wks = {name: pack(source, text, wt, s)
               for name, (_, text) in libs.items()}
        ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
        out = torch.empty((b, co, ho, wo), dtype=dtype, device='cuda',
                          memory_format=torch.channels_last)
        symbol = mod.LAUNCHERS[s]
        out_px = b * ho * wo
        bound = max(2 * out_px * co * c * 9 / peak,
                    (b * c * h * w + out_px * co) * size / 3.35e12) * 1e3
        # (variant, splits): simt at the plan's split count, and unsplit
        # beside it where the plan splits
        splits = (sm.plan_splits(b, h, w, c, co, sm.sm_count(0))
                  if source == 'simt' and s == 1 else 1)
        runs = [(name, n) for n in dict.fromkeys((splits, 1))
                for name in variants]
        ws = sm.workspace(splits, b, ho, wo, co, 'cuda')

        def label(run):
            name, n = run
            return (name if splits == 1 else
                    f'{name} split (s={n})' if n > 1 else f'{name} nosplit')

        def call(run):
            name, n = run
            args = ((b, h, w, c, co) if source == 'wgmma' else
                    (None if n == 1 else ws.data_ptr(), b, h, w, c, co, n))
            err = getattr(libs[name][0], symbol)(
                xk.data_ptr(), wks[name].data_ptr(), None, out.data_ptr(),
                *args, stream)
            if err:
                raise RuntimeError(f'{source} {label(run)} {role}: CUDA '
                                   f'error {err}')

        times = {run: [] for run in runs}
        for run in runs:
            call(run)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs()
            if not bool(torch.all(err <= atol + rtol * ref.abs())):
                raise RuntimeError(f'{source} {label(run)} {role}: max |d| '
                                   f'{float(err.max())}')
        for run in runs + runs[::-1]:
            for _ in range(3):
                call(run)
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                call(run)
            z.record()
            torch.cuda.synchronize()
            times[run].append(a.elapsed_time(z) / 20)
        print(f'{source} {role} bound {bound:.4f} ms: ' + ', '.join(
            f'{label(run)} {np.mean(t):.4f} ms ({bound / np.mean(t):.0%})'
            for run, t in times.items()), flush=True)
        del ref, xk, out, wks, ws
        torch.cuda.empty_cache()


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit('conv3x3_variants: needs a CUDA card')
    # the plain reference in full fp32 (cuDNN's default is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    for source in sources:
        if source not in VARIANTS:
            raise SystemExit(f'conv3x3_variants: unknown source {source!r} '
                             f'(expected {" or ".join(VARIANTS)})')
        time_source(source)


if __name__ == '__main__':
    main()
