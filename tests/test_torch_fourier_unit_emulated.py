"""The FourierUnit's CUDA source, run on the CPU.

csrc/fourier_unit.cu is built with g++ against tests/cuda_emu.h, a host
stand-in for the CUDA it uses (a std::thread per CUDA thread, a barrier
per __syncthreads, cp.async copies deferred to the wait_group that retires
them, shared memory filled with NaN bytes), after four textual
replacements: the cp.async helpers' inline PTX, the dynamic shared-memory
declaration and the two `<<<>>>` launches. Its extern "C" launcher then runs the
wrapper's stage plan (`fourier_unit._launch_plan`) on CPU tensors, and the
output is held to `fourier_unit_plain` on the same inputs: fp32 rtol/atol
1e-4 (summation order), bf16 input to the plain unit on the bf16-rounded
input at the same bound (the kernel widens bf16 exactly). The shapes cover
every tile instance, the 16-byte and the 4-byte / element copy paths, odd
sides, partial tiles, the zero rows, a persistent grid and K splits (the
stand-in card has EMU_SMS SMs), and a misaligned input. What only the
card shows (timing, registers, bank conflicts, the PTX) is
tests/test_torch_cuda.py's and chip_smoke.py's. Skips without g++.
"""
import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from lama_tpu_torch.ops.kernels import _build
from lama_tpu_torch.ops.kernels import fourier_unit as fu

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
EMU_SMS = 3   # cuda_emu.h's SM count


def host_source(src):
    """fourier_unit.cu with its device-only parts replaced by
    tests/cuda_emu.h's stand-ins."""
    src = src.replace('#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n',
                      '#include "cuda_emu.h"\n')
    for helper, body in (
            (r'void cp_async16\(uint32_t dst, const void\* src, int bytes\)',
             'emu_cp(dst, src, 16, bytes);'),
            (r'void cp_async4\(uint32_t dst, const void\* src, int bytes\)',
             'emu_cp(dst, src, 4, bytes);'),
            (r'void cp_async_commit\(\)', 'emu_commit();'),
            (r'void cp_async_wait\(\)', 'emu_wait(N);')):
        src, n = re.subn(rf'({helper} \{{)\n  asm volatile\(.*?\);\n\}}',
                         rf'\1 {body} }}', src, flags=re.S)
        assert n == 1, helper
    src = src.replace('extern __shared__ __align__(16) unsigned char smem[];',
                      'unsigned char* smem = emu_smem;')
    src, n = re.subn(r'(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(', r'emu_launch(\1, \2, ',
                     src, flags=re.S)
    assert n == 2 and 'asm' not in src and '__shared__' not in src
    return src


@pytest.fixture(scope='module')
def gemm(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip('needs g++')
    work = tmp_path_factory.mktemp('fu_emu')
    with open(_build.source_path('fourier_unit')) as f:
        (work / 'fourier_unit_host.cpp').write_text(host_source(f.read()))
    lib = work / 'fourier_unit_host.so'
    subprocess.run(['g++', '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-I', TESTS, '-o', str(lib),
                    str(work / 'fourier_unit_host.cpp')],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).lama_fu_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = fu.ARGTYPES
    return fn


def host_unit(gemm, x, conv_weight, bn, misalign=False, norm='ortho'):
    """The unit through the wrapper's cached launch plan (the twiddle
    tables of `norm`) and the host build of the kernel; x NCHW on the CPU,
    float32 or bfloat16. misalign: x one element past a 16-byte boundary,
    so its 16-byte copies are off."""
    b, c, h, w = x.shape
    co = conv_weight.shape[0] // 2
    wp, bp = fu.planar_params(conv_weight, *bn)
    xk = x.contiguous(memory_format=torch.channels_last)
    if misalign:
        buf = torch.empty(xk.numel() + 1, dtype=x.dtype)
        buf[1:] = xk.permute(0, 2, 3, 1).reshape(-1)
        xk = buf[1:].view(b, h, w, c).permute(0, 3, 1, 2)
    wf = w // 2 + 1
    s0 = torch.full((b * h * 2 * wf * max(c, co),), float('nan'))
    s1 = torch.full_like(s0, float('nan'))
    out = torch.full((b, co, h, w), float('nan')).contiguous(
        memory_format=torch.channels_last)
    launches, tabs, ws_floats = fu._launch_plan(
        b, h, w, c, co, x.dtype == torch.bfloat16, torch.device('cpu'),
        EMU_SMS, norm=norm)
    ws = torch.full((max(ws_floats, 1),), float('nan'))
    ptrs = {k: t.data_ptr() for k, t in tabs.items()}
    ptrs.update(x=xk.data_ptr(), s0=s0.data_ptr(), s1=s1.data_ptr(),
                wp=wp.data_ptr(), out=out.data_ptr())
    vecs, splits = [], []
    for stage, dims, a, bv, o, structs, bias in launches:
        for struct, name, vec in structs:
            struct.p = ptrs[name]
            struct.vec = int(vec and ptrs[name] % 16 == 0)
        o.bias = bp.data_ptr() if bias else None
        vecs.append((a.vec, bv.vec, o.vec))
        splits.append(dims[-1])
        assert gemm(*dims, ctypes.addressof(a), ctypes.addressof(bv),
                    ctypes.addressof(o), ws.data_ptr(), None) == 0, stage
    return out, vecs, splits


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,c,co,h,w', [
    (2, 8, 8, 8, 8),        # BM 128, one tile a stage
    (1, 3, 2, 7, 5),        # C % 4 != 0: 4-byte copies, element loads
    (2, 2, 3, 9, 6),
    (1, 16, 16, 13, 11),    # odd sides, BM 64
    (1, 12, 20, 6, 20),     # bf16 x with C % 8 != 0
    (1, 8, 8, 5, 95),       # BM 32 on the H stages, K = 95
    (1, 24, 8, 33, 48),     # BM 16 on the W-DFT, the refiner's W = 48
    (2, 16, 16, 24, 30),    # several M tiles, N tiles varying fastest
    (1, 192, 192, 8, 8)])   # the served widths: 3 N tiles in the conv
def test_kernel_source_on_the_host_matches_plain(gemm, dtype, b, c, co, h, w):
    g = torch.Generator().manual_seed(b + c + h + w)
    x = torch.rand(b, c, h, w, generator=g).to(dtype)
    conv = (torch.rand(2 * co, 2 * c, 1, 1, generator=g) * 2 - 1) * 0.3
    bn = (1 + 0.2 * torch.rand(2 * co, generator=g),
          0.1 * torch.rand(2 * co, generator=g),
          0.1 * torch.rand(2 * co, generator=g),
          1 + 0.3 * torch.rand(2 * co, generator=g))
    out, _, splits = host_unit(gemm, x, conv, bn)
    ref = fu.fourier_unit_plain(x.float(), conv, *bn)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    # on 3 SMs every shape but the first two splits K in some stage
    unsplit = (b, c, co, h, w) in ((2, 8, 8, 8, 8), (1, 3, 2, 7, 5))
    assert (max(splits) == 1) == unsplit, splits


@pytest.mark.parametrize('dtype,c', [(torch.float32, 8),
                                     (torch.bfloat16, 16)])
def test_kernel_source_on_the_host_with_a_misaligned_input(gemm, dtype, c):
    """x one element off a 16-byte boundary: the W-DFT's B operand takes
    the 4-byte (fp32) or element (bf16) path, the other operands still
    16-byte copies."""
    g = torch.Generator().manual_seed(7)
    x = torch.rand(1, c, 10, 12, generator=g).to(dtype)
    conv = (torch.rand(16, 2 * c, 1, 1, generator=g) * 2 - 1) * 0.3
    bn = (1 + 0.2 * torch.rand(16, generator=g), torch.zeros(16),
          torch.zeros(16), torch.ones(16))
    out, vecs, _ = host_unit(gemm, x, conv, bn, misalign=True)
    assert vecs[0] == (1, 0, 1) and all(v == (1, 1, 1) for v in vecs[1:])
    ref = fu.fourier_unit_plain(x.float(), conv, *bn)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('norm', ['backward', 'forward'])
@pytest.mark.parametrize('dtype,b,c,co,h,w', [
    (torch.float32, 2, 8, 8, 8, 8), (torch.bfloat16, 1, 16, 16, 13, 11),
    (torch.float32, 1, 8, 8, 5, 95)])
def test_kernel_source_on_the_host_with_other_norms(gemm, norm, dtype, b, c,
                                                    co, h, w):
    """The same source on the 'backward' and 'forward' table sets matches
    the plain unit of that norm: the norm lives in the tables only."""
    g = torch.Generator().manual_seed(b + c + h + w + 1)
    x = torch.rand(b, c, h, w, generator=g).to(dtype)
    conv = (torch.rand(2 * co, 2 * c, 1, 1, generator=g) * 2 - 1) * 0.3
    bn = (1 + 0.2 * torch.rand(2 * co, generator=g),
          0.1 * torch.rand(2 * co, generator=g),
          0.1 * torch.rand(2 * co, generator=g),
          1 + 0.3 * torch.rand(2 * co, generator=g))
    out, _, _ = host_unit(gemm, x, conv, bn, norm=norm)
    ref = fu.fourier_unit_plain(x.float(), conv, *bn, norm=norm)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
