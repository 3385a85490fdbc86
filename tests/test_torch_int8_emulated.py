"""The int8 conv's CUDA source, run on the CPU.

csrc/conv_int8.cu is built with g++ against tests/cuda_emu.h,
tests/cuda_emu_warp.h and tests/cuda_emu_wgmma.h (a std::thread per CUDA
thread, a barrier per __syncthreads, per warp and per warpgroup, cp.async
copies deferred to the wait_group that retires them, wgmma.mma_async
m64nNk32 s8 products deferred to the wgmma.wait_group that retires them
and computed from the no-swizzle descriptors as the PTX ISA lays the
operands and the accumulator fragment out, shared memory filled with 0xff
bytes), after textual replacements of its inline PTX, its shared-memory
declarations and its `<<<>>>` launches. Its three extern "C" launchers then
run on CPU tensors through the wrapper's plan and argument structure, and
each result is held to ops/quant.py's plain version on the same inputs:
the amax equal, the codes equal, the int32 sums equal, the fp32 and bf16
outputs bit-equal (the epilogue rounds once per operation, as the plain
dequantize does). The shapes cover both tile widths (an instance each over
several channel tiles), channel tails past C and C_out, several pixel
tiles, a K far longer than the pipeline ring, stride 1 and 2, the reflect,
replicate, zero and zero_pad borders, a 1x1 conv, three ConvTranspose
shapes (the four-phase k3 s2 p1 op1 among them), bf16 and fp32 inputs,
channels-last and NCHW. Timing, registers and the PTX are the card's
(tests/test_torch_cuda.py, chip_smoke.py). Skips without g++.
"""
import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from lama_tpu_torch.ops import quant
from lama_tpu_torch.ops.kernels import _build
from lama_tpu_torch.ops.kernels import conv_int8 as ci

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))


def host_source(src):
    """conv_int8.cu with its device-only parts replaced by the stand-ins."""
    src = src.replace('#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n',
                      '#include "cuda_emu_wgmma.h"\n')
    for helper, body in (
            (r'void cp_async16\(uint32_t dst, const void\* src,\s*int bytes\)',
             'emu_cp(dst, src, 16, bytes);'),
            (r'void cp_async_commit\(\)', 'emu_commit();'),
            (r'void cp_async_wait\(\)', 'emu_wait(N);'),
            (r'void fence_proxy_async\(\)', 'emu_fence_proxy_async();'),
            (r'void wgmma_fence\(\)', 'emu_wgmma_fence();'),
            (r'void wgmma_commit\(\)', 'emu_wgmma_commit();'),
            (r'void wgmma_wait_all\(\)', 'emu_wgmma_wait(0);'),
            (r'void wgmma_n192\(int \(&d\)\[96\], uint64_t da,\s*uint64_t db\)',
             'emu_wgmma_s8(d, da, db, 192);'),
            (r'void wgmma_n128\(int \(&d\)\[64\], uint64_t da,\s*uint64_t db\)',
             'emu_wgmma_s8(d, da, db, 128);'),
            (r'void wgmma_n64\(int \(&d\)\[32\], uint64_t da,\s*uint64_t db\)',
             'emu_wgmma_s8(d, da, db, 64);')):
        src, n = re.subn(rf'({helper} \{{)\n  asm volatile\(.*?\);\n\}}',
                         rf'\1 {body} }}', src, flags=re.S)
        assert n == 1, helper
    # the accumulator fence only orders the compiler's register accesses
    fence = 'asm volatile("" : "+r"(d[i]) :: "memory");'
    assert src.count(fence) == 1
    src = src.replace(fence, '(void)d[i];')
    src = src.replace('extern __shared__ __align__(128) unsigned char smem[];',
                      'unsigned char* smem = emu_smem;')
    src = src.replace('__shared__ float red[', 'static float red[')
    src, n = re.subn(r'(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(', r'emu_launch2(\1, \2, ',
                     src, flags=re.S)
    assert n == 3 and 'asm' not in src and '__shared__' not in src
    return src


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip('needs g++')
    work = tmp_path_factory.mktemp('int8_emu')
    with open(_build.source_path('conv_int8')) as f:
        (work / 'conv_int8_host.cpp').write_text(host_source(f.read()))
    so = work / 'conv_int8_host.so'
    subprocess.run(['g++', '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-I', TESTS, '-o', str(so), str(work / 'conv_int8_host.cpp')],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.lama_int8_amax.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.lama_int8_quantize.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    lib.lama_int8_conv.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
    return lib


def host_quantize(lib, x, act_amax=None):
    """quantize_activation's two launches on the host build."""
    b, c, h, w = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    if act_amax is None:
        dense = x if (x.is_contiguous() or x.is_contiguous(
            memory_format=torch.channels_last)) else x.contiguous()
        amax = torch.full((1,), float('nan'))
        assert lib.lama_int8_amax(dense.data_ptr(), bf16, dense.numel(),
                                  amax.data_ptr(), None) == 0
    else:
        amax = act_amax.reshape(1).float()
    cp = ci.round_up(c, ci.CHUNK)
    xq = torch.full((b, h, w, cp), 99, dtype=torch.int8)
    assert lib.lama_int8_quantize(x.data_ptr(), bf16, b, c, h, w, *x.stride(),
                                  cp, amax.data_ptr(), xq.data_ptr(),
                                  None) == 0
    return xq, amax


def host_conv(lib, xq, amax, weight, bias, plan, co, out_dtype,
              transposed=False):
    packed, s_w = ci.pack_weight(weight, transposed)
    out = torch.full((xq.shape[0], co, plan.ho, plan.wo), -7,
                     dtype=out_dtype).contiguous(
        memory_format=torch.channels_last)
    args = ci.conv_args(xq, amax, packed, s_w, bias, plan, out)
    assert lib.lama_int8_conv(ctypes.addressof(args), ci.tile_n(co),
                              None) == 0
    return out


def _inputs(seed, b, c, h, w, co, k, dtype, channels_last, transposed=False):
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(b, c, h, w, generator=g) * 2 - 1).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    shape = (c, co, k, k) if transposed else (co, c, k, k)
    weight = (torch.rand(*shape, generator=g) * 2 - 1) * (c * k * k) ** -0.5
    bias = torch.rand(co, generator=g) * 0.2 - 0.1
    return x, weight, bias


# (b, c, h, w, co, k, stride, padding mode, zero_pad, dtype, channels-last)
CONV_CASES = [
    (2, 40, 9, 9, 72, 3, 1, 'reflect', False, torch.float32, True),
    (1, 64, 11, 11, 64, 3, 2, 'reflect', False, torch.bfloat16, True),
    (1, 32, 7, 6, 48, 3, 1, 'reflect', True, torch.bfloat16, False),
    (1, 64, 12, 10, 40, 3, 2, 'zeros', False, torch.float32, False),
    (2, 96, 5, 5, 40, 1, 1, 'zeros', False, torch.bfloat16, True),
    # K of 27 stages (9 taps x 12 chunks), far past the 4-deep ring
    (1, 384, 6, 5, 64, 3, 1, 'reflect', False, torch.bfloat16, True),
    # one case per instance over several channel tiles: BN 64 over five
    # (C_out 288), BN 128 over two with a tail (C_out 232) and two pixel
    # tiles (M 312 > 256), the replicate border; BN 192 over two (C_out 384,
    # as the SpectralTransform's 1x1 out, whose K is one whole 128-byte
    # channel group and a shorter one) and over one with a tail (C_out 150)
    (1, 64, 6, 7, 288, 3, 1, 'reflect', False, torch.float32, True),
    (2, 32, 13, 12, 232, 3, 1, 'replicate', False, torch.bfloat16, True),
    (1, 192, 6, 7, 384, 1, 1, 'zeros', False, torch.bfloat16, True),
    (1, 96, 5, 6, 150, 3, 1, 'zeros', False, torch.bfloat16, False),
    # K in channel groups of 128 bytes: one whole group and a shorter one
    (1, 160, 5, 6, 48, 3, 1, 'reflect', True, torch.float32, False),
]


def test_conv_cases_cover_every_instance():
    """Each kernel instance (tile width) runs some case over more than one
    channel tile, and some case's K outlasts the pipeline ring."""
    multi = {ci.tile_n(co) for _, _, _, _, co, *_ in CONV_CASES
             if co > ci.tile_n(co)}
    assert multi == set(ci.TILE_N)
    assert any(k * k * ci.round_up(c, ci.CHUNK) // ci.CHUNK
               > ci.STAGES * ci.KCH for _, c, _, _, _, k, *_ in CONV_CASES)


@pytest.mark.parametrize('b,c,h,w,co,k,stride,mode,zero_pad,dtype,cl',
                         CONV_CASES)
def test_conv_source_on_the_host_matches_plain(lib, b, c, h, w, co, k, stride,
                                               mode, zero_pad, dtype, cl):
    x, weight, bias = _inputs(b + c + h, b, c, h, w, co, k, dtype, cl)
    pad = k // 2
    xq, amax = host_quantize(lib, x)
    assert float(amax) == float(x.float().abs().max())
    s_x = quant.act_scale(x)
    codes = quant.quantize(x, s_x)
    assert torch.equal(xq[..., :c], codes.permute(0, 2, 3, 1))
    assert not xq[..., c:].any()
    plan = ci.conv_plan(x.shape, weight.shape, stride, pad, 1, 1, mode,
                        zero_pad)
    acc = host_conv(lib, xq, amax, weight, None, plan, co, torch.int32)
    wq, s_w = quant.quantize_weight(weight)
    ref = quant.conv2d_acc(codes, wq, stride, pad, 1, 1, mode, zero_pad)
    assert torch.equal(acc, ref)
    for out_dtype in (torch.float32, torch.bfloat16):
        out = host_conv(lib, xq, amax, weight, bias, plan, co, out_dtype)
        ref = quant.quantized_conv2d(x, weight, bias, stride, pad, 1, 1, mode,
                                     out_dtype=out_dtype, zero_pad=zero_pad)
        assert torch.equal(out, ref), out_dtype
    # a calibrated amax: the quantize launch alone, with that scale
    amax_static = torch.tensor(0.5 * float(x.float().abs().max()))
    xq2, _ = host_quantize(lib, x, amax_static)
    assert torch.equal(xq2[..., :c], quant.quantize(
        x, quant.act_scale(x, amax_static)).permute(0, 2, 3, 1))


# the multidilated branches' convs, 3x3 with pad = dilation: (b, c, h, w,
# co, stride, dilation, padding mode, zero_pad, dtype); the reflect pad of 8
# stays below the side
DILATED_CASES = [
    (1, 64, 9, 10, 72, 1, 2, 'reflect', False, torch.bfloat16),
    (2, 32, 10, 9, 48, 1, 8, 'reflect', False, torch.float32),
    (1, 64, 9, 10, 72, 1, 2, 'zeros', False, torch.float32),
    (1, 32, 10, 11, 150, 1, 8, 'zeros', False, torch.bfloat16),
    (1, 64, 9, 10, 64, 1, 2, 'reflect', True, torch.bfloat16),
    (1, 32, 10, 9, 48, 1, 8, 'reflect', True, torch.float32),
    (1, 64, 11, 10, 72, 2, 2, 'reflect', False, torch.bfloat16),
]


@pytest.mark.parametrize('b,c,h,w,co,stride,d,mode,zero_pad,dtype',
                         DILATED_CASES)
def test_dilated_conv_source_on_the_host_matches_plain(lib, b, c, h, w, co,
                                                       stride, d, mode,
                                                       zero_pad, dtype):
    """Dilations 2 and 8 with reflect, zero and zero_pad borders, and
    stride 2 with dilation 2: the int32 sums bit-equal to the plain
    version's, the outputs equal."""
    x, weight, bias = _inputs(b + c + d, b, c, h, w, co, 3, dtype, True)
    xq, amax = host_quantize(lib, x)
    codes = quant.quantize(x, quant.act_scale(x))
    plan = ci.conv_plan(x.shape, weight.shape, stride, d, d, 1, mode,
                        zero_pad)
    acc = host_conv(lib, xq, amax, weight, None, plan, co, torch.int32)
    wq, _ = quant.quantize_weight(weight)
    ref = quant.conv2d_acc(codes, wq, stride, d, d, 1, mode, zero_pad)
    assert acc.shape == ref.shape and torch.equal(acc, ref)
    out = host_conv(lib, xq, amax, weight, bias, plan, co, dtype)
    assert torch.equal(out, quant.quantized_conv2d(
        x, weight, bias, stride, d, d, 1, mode, out_dtype=dtype,
        zero_pad=zero_pad))


@pytest.mark.parametrize('stride,padding,output_padding,taps', [
    (2, 1, 1, [1, 2, 2, 4]), (2, 0, 0, [4, 2, 2, 1]), (1, 1, 0, [9])])
def test_conv_transpose_source_on_the_host_matches_plain(
        lib, stride, padding, output_padding, taps):
    x, weight, bias = _inputs(stride + padding, 1, 64, 5, 4, 32, 3,
                              torch.bfloat16, True, transposed=True)
    plan = ci.conv_transpose_plan(x.shape, weight.shape, stride, padding,
                                  output_padding)
    assert [len(p.taps) for p in plan.phases] == taps
    xq, amax = host_quantize(lib, x)
    acc = host_conv(lib, xq, amax, weight, None, plan, 32, torch.int32,
                    transposed=True)
    wq, _ = quant.quantize_weight(weight, transposed=True)
    ref = quant.conv_transpose2d_acc(quant.quantize(x, quant.act_scale(x)),
                                     wq, stride, padding, output_padding)
    assert acc.shape == ref.shape and torch.equal(acc, ref)
    out = host_conv(lib, xq, amax, weight, bias, plan, 32, torch.bfloat16,
                    transposed=True)
    assert torch.equal(out, quant.quantized_conv_transpose2d(
        x, weight, bias, stride, padding, output_padding))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_quantize_source_rounds_half_to_even(lib, dtype):
    """amax 127 makes the scale exactly 1, so x / s lands on exact halves:
    the kernel's codes are torch.round's (half to even: 2.5 -> 2, -3.5 ->
    -4, 0.5 -> 0), which roundf (half away from zero) would miss."""
    halves = torch.arange(-20, 20, dtype=torch.float32) + 0.5
    x = torch.cat([torch.tensor([127.0]), halves, halves[:23]]).to(dtype)
    x = x.reshape(1, 64, 1, 1).contiguous(memory_format=torch.channels_last)
    xq, amax = host_quantize(lib, x)
    assert float(amax) == 127.0
    codes = quant.quantize(x, quant.act_scale(x))
    assert torch.equal(xq[..., :64], codes.permute(0, 2, 3, 1))
    assert int(codes[0, 1 + 22]) == 2 and int(codes[0, 1 + 16]) == -4
