"""The head conv's CUDA source (kernel 5), its fp32 instances run on the CPU.

csrc/reflect_conv.cu is built with g++ against tests/cuda_emu.h, a host
stand-in for the CUDA it uses (a std::thread per CUDA thread, a barrier
per __syncthreads, cp.async copies deferred to the wait_group that retires
them, shared memory filled with NaN bytes, a card of 3 SMs), after textual
replacements: the inline PTX of the cp.async helpers, the ldmatrix and
mma.sync helpers (stubs that abort: the bf16 instances build but do not
run here; their fragment maps are replayed in numpy in
tests/test_torch_kernels.py), the dynamic shared-memory declaration and
the `<<<>>>` launch. Its extern "C" launcher then runs on CPU tensors with
the wrapper's packed weights, and the output is held to
`reflect_conv_plain` on the same inputs at rtol/atol 1e-4 (fp32 summation
order). The shapes cover C = 8, 16, 64 and 128 (the weights staged once a
block, and per chunk where they do not fit), C_out 1, 3 and 8, odd sides
and partial tiles (37 x 70, W = 760), H or W = 8, bias and none, several
tiles a block on the stand-in's 3 SMs, a misaligned input, and shapes
outside the envelope refused. Skips without g++.
"""
import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from lama_tpu_torch.ops.kernels import _build
from lama_tpu_torch.ops.kernels import head_conv as hc
from lama_tpu_torch.ops.kernels.reflect_conv import reflect_conv_plain

torch.set_num_threads(1)
EMU_SMS = 3   # cuda_emu.h's SM count
TESTS = os.path.dirname(os.path.abspath(__file__))


def host_source(src):
    """reflect_conv.cu with its device-only parts replaced by
    tests/cuda_emu.h's stand-ins."""
    src = src.replace('#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n',
                      '#include "cuda_emu.h"\n')
    for helper, body in (
            (r'void cp_async16\(uint32_t dst, const void\* src, int bytes\)',
             'emu_cp(dst, src, 16, bytes);'),
            (r'void cp_async4\(uint32_t dst, const void\* src, int bytes\)',
             'emu_cp(dst, src, 4, bytes);'),
            (r'void cp_async_commit\(\)', 'emu_commit();'),
            (r'void cp_async_wait\(\)', 'emu_wait(N);'),
            (r'void ldmatrix_x4\(uint32_t \(&a\)\[4\], uint32_t addr\)',
             'emu_fail("ldmatrix");'),
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
def head(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip('needs g++')
    work = tmp_path_factory.mktemp('head_emu')
    with open(_build.source_path('reflect_conv')) as f:
        (work / 'reflect_conv_host.cpp').write_text(host_source(f.read()))
    lib = work / 'reflect_conv_host.so'
    subprocess.run(['g++', '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-I', TESTS, '-o', str(lib),
                    str(work / 'reflect_conv_host.cpp')],
                   check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(lib)).lama_reflect_out_conv7x7
    fn.restype = ctypes.c_int
    fn.argtypes = hc.ARGTYPES
    return fn


def host_head(fn, x, weight, bias, misalign=False):
    """The fp32 kernel through the host build: x NCHW on the CPU; the output
    starts as NaN, so a pixel the kernel does not write shows."""
    b, c, h, w = x.shape
    co = weight.shape[0]
    xk = x.contiguous(memory_format=torch.channels_last)
    if misalign:   # one element past a 16-byte boundary
        buf = torch.empty(xk.numel() + 1)
        buf[1:] = xk.permute(0, 2, 3, 1).reshape(-1)
        xk = buf[1:].view(b, h, w, c).permute(0, 3, 1, 2)
        assert xk.data_ptr() % 16
    wk = hc.pack_weight(weight, torch.float32)
    bk = None if bias is None else bias.float().contiguous()
    out = torch.full((b, co, h, w), float('nan')).contiguous(
        memory_format=torch.channels_last)
    err = fn(xk.data_ptr(), wk.data_ptr(), None if bk is None else bk.data_ptr(),
             out.data_ptr(), b, h, w, c, co, 0, None)
    assert err == 0
    return out


HOST_CASES = [
    # (B, C, C_out, H, W, bias, misalign)
    (1, 64, 3, 32, 64, True, False),     # one whole tile: one block
    (2, 64, 3, 37, 70, True, False),     # odd sides, partial tiles: 8 tiles
    (1, 8, 1, 8, 9, False, False),       # C = 8 (two chunks), C_out 1, H = 8
    (1, 16, 8, 13, 8, True, False),      # C_out 8, W = 8
    (1, 128, 3, 9, 20, False, False),    # C = 128, weights once a block
    (1, 128, 8, 10, 11, True, False),    # C = 128, C_out 8: per chunk
    (1, 16, 3, 8, 760, True, False),     # W = 760: 12 tiles, 4 a block
    (1, 24, 3, 19, 30, True, True),      # misaligned x
]


@pytest.mark.parametrize('b,c,co,h,w,bias,misalign', HOST_CASES)
def test_head_source_on_the_host_matches_plain(head, b, c, co, h, w, bias,
                                               misalign):
    g = torch.Generator().manual_seed(b + c + co + h + w)
    x = torch.rand(b, c, h, w, generator=g)
    wt = (torch.rand(co, c, 7, 7, generator=g) * 2 - 1) * (c * 49) ** -0.5
    bb = torch.rand(co, generator=g) if bias else None
    out = host_head(head, x, wt, bb, misalign)
    ref = reflect_conv_plain(x, wt, bb)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_head_source_cases_cover_the_plan():
    """The cases above walk several tiles a block (more tiles than the
    stand-in's 3 SMs) and stage the weights both ways."""
    f32 = torch.float32
    assert len(hc.out_tiles(f32, 3, 2, 37, 70)) == 8 > EMU_SMS
    assert len(hc.out_tiles(f32, 3, 1, 8, 760)) == 12 > EMU_SMS
    assert hc.layout(f32, 64, 3)['once'] and hc.layout(f32, 16, 8)['once']
    assert hc.layout(f32, 128, 3)['once']
    assert not hc.layout(f32, 128, 8)['once']


def test_head_source_refuses_shapes_outside_its_envelope(head):
    x = torch.rand(1, 64, 16, 16).contiguous(memory_format=torch.channels_last)
    wk = hc.pack_weight(torch.zeros(8, 136, 7, 7), torch.float32)
    out = torch.empty(8 * 16 * 16)
    for c, co, h, w in ((0, 3, 16, 16), (12, 3, 16, 16), (136, 3, 16, 16),
                        (64, 0, 16, 16), (64, 9, 16, 16), (64, 3, 7, 16),
                        (64, 3, 16, 7)):
        assert head(x.data_ptr(), wk.data_ptr(), None, out.data_ptr(), 1, h, w,
                    c, co, 0, None) != 0, (c, co, h, w)
    # a weight image that is not 16-byte aligned
    assert head(x.data_ptr(), wk.data_ptr() + 4, None, out.data_ptr(), 1, 16,
                16, 64, 3, 0, None) != 0
