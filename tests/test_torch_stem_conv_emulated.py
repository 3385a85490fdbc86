"""The stem conv's CUDA source, its fp32 instances run on the CPU.

csrc/stem_conv.cu is built with g++ against tests/cuda_emu.h, a host
stand-in for the CUDA it uses (a std::thread per CUDA thread, a barrier
per __syncthreads, cp.async copies deferred to the wait_group that retires
them, shared memory filled with NaN bytes, a card of 3 SMs), after textual
replacements: the inline PTX of the cp.async helpers, the mma.sync helper
(a stub that aborts: the bf16 instances build but do not run here; their
fragment map is replayed in tests/test_torch_stem_conv.py), the dynamic
shared-memory declaration and the `<<<>>>` launch. Its extern "C" launcher
then runs on CPU tensors with the wrapper's packed weights, and the output
is held to `reflect_conv_plain` on the same inputs at rtol/atol 1e-4 (fp32
summation order). The shapes cover C = 1, 3, 4, 5, 6 and 8 (pitch 4 and 8,
the one-copy and the element paths), C_out 16, 32, 48 and 64, odd sides,
partial tiles, bias and none, several tiles a block on the 3 SMs of the
stand-in, H or W = 4, and a misaligned input. Skips without g++.
"""
import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from lama_tpu_torch.ops.kernels import _build
from lama_tpu_torch.ops.kernels import stem_conv as sc
from lama_tpu_torch.ops.kernels.reflect_conv import reflect_conv_plain

torch.set_num_threads(1)
EMU_SMS = 3   # cuda_emu.h's SM count
TESTS = os.path.dirname(os.path.abspath(__file__))


def host_source(src):
    """stem_conv.cu with its device-only parts replaced by
    tests/cuda_emu.h's stand-ins."""
    src = src.replace('#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n',
                      '#include "cuda_emu.h"\n')
    for helper, body in (
            (r'void cp_async16\(uint32_t dst, const void\* src, int bytes\)',
             'emu_cp(dst, src, 16, bytes);'),
            (r'void cp_async8\(uint32_t dst, const void\* src, int bytes\)',
             'emu_cp(dst, src, 8, bytes);'),
            (r'void cp_async_commit\(\)', 'emu_commit();'),
            (r'void cp_async_wait\(\)', 'emu_wait(N);'),
            (r'void mma_bf16\(float \(&d\)\[4\], const uint32_t \(&a\)\[4\],'
             r'\s*uint32_t b0, uint32_t b1\)', 'emu_fail("mma.sync");')):
        src, n = re.subn(rf'({helper} \{{)\n  asm volatile\(.*?\);\n\}}',
                         rf'\1 {body} }}', src, flags=re.S)
        assert n == 1, helper
    src = src.replace('extern __shared__ __align__(16) unsigned char smem[];',
                      'unsigned char* smem = emu_smem;')
    src, n = re.subn(r'(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(', r'emu_launch(\1, \2, ',
                     src, flags=re.S)
    assert n == 1 and 'asm' not in src and '__shared__' not in src
    return src


@pytest.fixture(scope='module')
def stem(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip('needs g++')
    work = tmp_path_factory.mktemp('stem_emu')
    with open(_build.source_path('stem_conv')) as f:
        (work / 'stem_conv_host.cpp').write_text(host_source(f.read()))
    lib = work / 'stem_conv_host.so'
    subprocess.run(['g++', '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-I', TESTS, '-o', str(lib), str(work / 'stem_conv_host.cpp')],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).lama_stem_conv
    fn.restype = ctypes.c_int
    fn.argtypes = sc.ARGTYPES
    return fn


def host_stem(fn, x, weight, bias, misalign=False):
    """The fp32 kernel through the host build: x NCHW on the CPU; the output
    starts as NaN, so a pixel the kernel does not write shows."""
    b, c, h, w = x.shape
    co = weight.shape[0]
    xk = x.contiguous(memory_format=torch.channels_last)
    if misalign:   # one element past a 16-byte boundary: the element path
        buf = torch.empty(xk.numel() + 1)
        buf[1:] = xk.permute(0, 2, 3, 1).reshape(-1)
        xk = buf[1:].view(b, h, w, c).permute(0, 3, 1, 2)
    wk = sc.pack_weight(weight, torch.float32)
    bk = None if bias is None else bias.float().contiguous()
    out = torch.full((b, co, h, w), float('nan')).contiguous(
        memory_format=torch.channels_last)
    err = fn(xk.data_ptr(), wk.data_ptr(), None if bk is None else bk.data_ptr(),
             out.data_ptr(), b, h, w, c, co, 0, None)
    assert err == 0
    return out


@pytest.mark.parametrize('b,c,co,h,w,bias,misalign', [
    (1, 4, 64, 8, 32, True, False),    # one whole tile: one block
    (2, 4, 64, 19, 45, False, False),  # odd sides, partial tiles: 12 tiles
    (1, 1, 16, 4, 37, True, False),    # C = 1, C_out 16, H = 4
    (2, 3, 64, 13, 4, False, False),   # C = 3 (element path), W = 4
    (1, 8, 64, 17, 33, True, False),   # pitch 8, two 16-byte copies a pixel
    (1, 6, 32, 9, 40, True, False),    # pitch 8, element path, C_out 32
    (1, 5, 48, 11, 70, False, False),  # C_out 48: half the upper channels
    (1, 4, 64, 12, 36, True, True),    # misaligned x: the element path
])
def test_stem_source_on_the_host_matches_plain(stem, b, c, co, h, w, bias,
                                               misalign):
    g = torch.Generator().manual_seed(b + c + co + h + w)
    x = torch.rand(b, c, h, w, generator=g)
    wt = (torch.rand(co, c, 7, 7, generator=g) * 2 - 1) * (c * 49) ** -0.5
    bb = torch.rand(co, generator=g) if bias else None
    out = host_stem(stem, x, wt, bb, misalign)
    ref = reflect_conv_plain(x, wt, bb)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_stem_source_walks_several_tiles_a_block():
    """The shapes above give the persistent grid more tiles than the
    stand-in's 3 blocks (one a SM in fp32), so blocks walk several tiles
    and the halo ring turns over."""
    assert len(sc.out_tiles(2, 19, 45)) == 12 > EMU_SMS
    assert len(sc.out_tiles(1, 11, 70)) == 6 > EMU_SMS


def test_stem_source_refuses_shapes_outside_its_envelope(stem):
    x = torch.rand(1, 4, 8, 8).contiguous(memory_format=torch.channels_last)
    for c, co, h, w in ((9, 64, 8, 8), (4, 24, 8, 8), (4, 80, 8, 8),
                        (4, 64, 3, 8), (0, 64, 8, 8)):
        wk = sc.pack_weight(torch.zeros(64, 4, 7, 7), torch.float32)
        out = torch.empty(1 * 80 * 8 * 8)
        assert stem(x.data_ptr(), wk.data_ptr(), None, out.data_ptr(), 1, h, w,
                    c, co, 0, None) != 0, (c, co, h, w)
