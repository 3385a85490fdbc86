"""Time variants of csrc/conv3x3_wgmma.cu against each other on one card.

    python -m lama_tpu_torch.tools.conv3x3_variants

Each variant is the source with some of its constants replaced (VARIANTS
below). All are built with the port's nvcc flags into
lama_tpu_torch/_build/variants/ and launched through their extern "C"
launchers on channels-last bf16 inputs with the weights packed once, so a
time is the kernel alone: CUDA events around 20 back-to-back launches,
after 3 warm-up launches, each variant twice in turns (a, b, ..., b, a), at
big-lama's served shapes (batch 16: the four downsamples at stride 2, l2l,
l2g, g2l, and big-lama-regular's 512 -> 512 block) and a few smaller ones.
Each output is first held to the plain fp32 conv (max |d| < 5e-2). Prints
each variant's ptxas lines, then per shape the bound (bytes at 3.35 TB/s or
FLOP at 989 TFLOP/s, the larger) and each variant's ms and share of it.
Needs a CUDA card and nvcc; imports nothing at module level beyond torch.
"""
import ctypes
import os
import subprocess

import numpy as np
import torch

from ..ops.kernels import _build
from ..ops.kernels import conv3x3_wgmma as wg
from ..ops.kernels.reflect_conv import reflect_conv_plain

VARIANTS = {
    'base': [],
    # stride 2 with two stages instead of three
    's2_ring2': [('constexpr int S2_STAGES = 3;', 'constexpr int S2_STAGES = 2;')],
    # stride 1 with stride 2's 16-channel stages, three or four of them
    's1_c16_ring3': [
        ('CHUNK = S == 1 ? CHUNK_C : S2_CHUNK_C', 'CHUNK = S == 1 ? 16 : S2_CHUNK_C'),
        ('RING = S == 1 ? STAGES : S2_STAGES', 'RING = S == 1 ? 3 : S2_STAGES')],
    's1_c16_ring4': [
        ('CHUNK = S == 1 ? CHUNK_C : S2_CHUNK_C', 'CHUNK = S == 1 ? 16 : S2_CHUNK_C'),
        ('RING = S == 1 ? STAGES : S2_STAGES', 'RING = S == 1 ? 4 : S2_STAGES')],
}
SHAPES = [  # role, stride, batch, C, C_out, (H, W) of the input
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
]
OUT_DIR = os.path.join(_build.BUILD_DIR, 'variants')


def build():
    """Write and compile every variant (one nvcc each, all at once);
    returns the loaded libraries by name."""
    src = open(_build.source_path('conv3x3_wgmma')).read()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            assert old in text, (name, old)
            text = text.replace(old, new)
        cu = os.path.join(OUT_DIR, name + '.cu')
        with open(cu, 'w') as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, '-o', cu[:-3] + '.so', cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        print(name, [ln.strip() for ln in log.splitlines()
                     if 'registers' in ln or 'spill' in ln], flush=True)
        lib = ctypes.CDLL(os.path.join(OUT_DIR, name + '.so'))
        for symbol in wg.LAUNCHERS.values():
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit('conv3x3_variants: needs a CUDA card')
    libs = build()
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for role, s, b, c, co, (h, w) in SHAPES:
        x = torch.rand(b, c, h, w, generator=g).cuda()
        wt = ((torch.rand(co, c, 3, 3, generator=g) * 2 - 1)
              * (9 * c) ** -0.5).cuda()
        ref = reflect_conv_plain(x, wt, None, s)
        xb = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        del x
        wk = wg.pack_conv3x3_weight(wt)
        out = torch.empty((b, co, h // s, w // s), dtype=torch.bfloat16,
                          device='cuda', memory_format=torch.channels_last)
        symbol = wg.LAUNCHERS[s]
        out_px = b * (h // s) * (w // s)
        bound = max(2 * out_px * co * c * 9 / 989e12,
                    (b * c * h * w + out_px * co) * 2 / 3.35e12) * 1e3

        def call(name):
            err = getattr(libs[name], symbol)(
                xb.data_ptr(), wk.data_ptr(), None, out.data_ptr(), b, h, w,
                c, co, stream)
            if err:
                raise RuntimeError(f'{name} {role}: CUDA error {err}')

        times = {name: [] for name in VARIANTS}
        for name in VARIANTS:
            call(name)
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max())
            if not err < 5e-2:
                raise RuntimeError(f'{name} {role}: max |d| {err}')
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            for _ in range(3):
                call(name)
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                call(name)
            z.record()
            torch.cuda.synchronize()
            times[name].append(a.elapsed_time(z) / 20)
        print(f'{role} bound {bound:.4f} ms: ' + ', '.join(
            f'{name} {np.mean(t):.4f} ms ({bound / np.mean(t):.0%})'
            for name, t in times.items()), flush=True)
        del ref, xb, out
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
