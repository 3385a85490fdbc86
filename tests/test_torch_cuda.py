"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked `cuda`; every test skips without a card (decided inside the fixture,
never at import). Run on a machine with one:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
(--noconftest: tests/conftest.py sets up JAX, which the card's machine
does not need.)
Bounds: fp32 kernel vs fp32 plain rtol 1e-4 / atol 1e-4 (summation order);
bf16 kernel vs the fp32 plain output rtol 2e-2 / atol 2e-2 (bf16 operands).
Gradients through a kernel's autograd wrapper (backward: the plain
version's VJP) vs plain autograd, fp32, under a linear loss, so both
backwards see the same output gradient: rtol 1e-4 / atol 1e-5 times the
largest gradient (cuDNN's algorithm choice only).
chip_smoke.py holds the same kernels at the big-lama and big-lama-regular
shapes.
"""
import contextlib
import os

import pytest
import torch

from lama_tpu_torch.ops.kernels import fourier_unit as fu
from lama_tpu_torch.ops.kernels import reflect_conv as rc

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _close(out, ref, dtype):
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name,c,co,h,w,k,bias,batch', [
    ('reflect_conv3x3_cols', 128, 128, 16, 24, 3, False, 2),
    ('reflect_conv3x3_cols', 128, 128, 13, 9, 3, True, 2),     # partial tiles
    ('reflect_conv3x3_taps', 384, 128, 16, 16, 3, False, 2),
    ('reflect_conv3x3_taps', 128, 384, 8, 40, 3, True, 2),
    ('reflect_out_conv7x7', 64, 3, 37, 70, 7, True, 2),
    ('reflect_out_conv7x7', 16, 8, 8, 8, 7, False, 2),
    # the head's envelope corners: C 8, 24 and 128 (at C_out 8 its
    # weights staged per chunk), C_out 1 and 8
    ('reflect_out_conv7x7', 8, 1, 9, 12, 7, True, 2),
    ('reflect_out_conv7x7', 24, 8, 19, 61, 7, False, 1),
    ('reflect_out_conv7x7', 128, 3, 20, 130, 7, True, 1),
    ('reflect_out_conv7x7', 128, 8, 17, 33, 7, True, 1),
    ('reflect_down_conv3x3', 64, 128, 16, 24, 3, False, 2),
    ('reflect_down_conv3x3', 128, 256, 26, 10, 3, True, 2),    # partial tiles
    ('reflect_down_conv3x3', 256, 384, 8, 8, 3, False, 2),
    # the refiner's odd bottleneck sides (1000x760 / 8) and partial tiles
    ('reflect_conv3x3_taps', 128, 384, 25, 19, 3, False, 2),
    ('reflect_down_conv3x3', 64, 128, 50, 38, 3, False, 2),
    # taps on the wgmma kernel's 16x16-pixel, 128-channel tiles: sides
    # that are not multiples of 16, eight channel chunks and four output
    # tiles, and the served batch 16
    ('reflect_conv3x3_taps', 384, 128, 9, 8, 3, True, 1),
    ('reflect_conv3x3_taps', 256, 512, 20, 30, 3, False, 2),
    ('reflect_conv3x3_taps', 128, 384, 64, 64, 3, False, 16),
    # the multidilated generator's dilation-1 branch (ablv2_work_md: cat_in,
    # 128 of the block's 512 channels -> 512), at 16^2 and the served b16
    ('reflect_conv3x3_taps', 128, 512, 16, 16, 3, True, 2),
    ('reflect_conv3x3_taps', 128, 512, 64, 64, 3, True, 16),
    # bf16 cols and down on the wgmma kernel (down: its stride-2 form, 16x16
    # output tiles, 16-channel chunks): output sides that are not multiples
    # of 16 (20x35), C = 64 (four chunks), C = 256 -> 384 (three N tiles,
    # sixteen chunks), the smallest input (8x8), bias, and the served
    # batch 16 of both
    ('reflect_down_conv3x3', 64, 128, 40, 70, 3, True, 2),
    ('reflect_down_conv3x3', 256, 384, 36, 20, 3, True, 1),
    ('reflect_down_conv3x3', 128, 128, 8, 8, 3, True, 1),
    ('reflect_down_conv3x3', 64, 128, 64, 64, 3, False, 16),
    ('reflect_conv3x3_cols', 128, 128, 64, 64, 3, False, 16),
])
def test_reflect_conv_kernel(device, dtype, name, c, co, h, w, k, bias, batch):
    g = torch.Generator().manual_seed(0)
    x = torch.rand(batch, c, h, w, generator=g).to(device)
    wt = ((torch.rand(co, c, k, k, generator=g) * 2 - 1)
          * (c * k * k) ** -0.5).to(device)
    b = torch.rand(co, generator=g).to(device) if bias else None
    ref = rc.reflect_conv_plain(x, wt, b, stride=2 if 'down' in name else 1)
    fn = getattr(rc, name)
    before = fn.launches
    out = fn(x.to(dtype), wt, b)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    _close(out, ref, dtype)


@pytest.mark.parametrize('b,c,co,h,w,bias', [
    (2, 24, 40, 18, 30, True),         # C % 16, C_out % 128
    (2, 12, 20, 22, 34, False),        # C % 8: element loads
    (1, 1, 8, 2, 2, True),             # the smallest input, one output pixel
    (2, 96, 136, 34, 66, False),       # partial tiles, two N tiles
])
def test_conv3x3_wgmma_stride2_any_widths(device, b, c, co, h, w, bias):
    """The stride-2 wgmma kernel outside kernel 4's envelope too (any C,
    C_out; H, W even): channel tails by the copies' zero fill, element
    loads, partial tiles."""
    from lama_tpu_torch.ops.kernels import conv3x3_wgmma as wg
    g = torch.Generator().manual_seed(c + co)
    x = torch.rand(b, c, h, w, generator=g).to(device)
    wt = ((torch.rand(co, c, 3, 3, generator=g) * 2 - 1)
          * (c * 9) ** -0.5).to(device)
    bb = torch.rand(co, generator=g).to(device) if bias else None
    ref = rc.reflect_conv_plain(x, wt, bb, stride=2)
    out = wg.conv3x3_reflect_bf16(
        x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last),
        wt, bb, stride=2)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    _close(out, ref, torch.bfloat16)


def test_bf16_3x3_wrappers_launch_the_wgmma_kernel(device, monkeypatch):
    """bf16 cols, taps, down and the 3x3 halo conv go to conv3x3_wgmma.cu's
    launchers (stride 1 and 2); in fp32 down goes to conv3x3_simt.cu's
    stride-2 launcher and cols, taps and the 3x3 halo conv to its stride-1
    one. No 3x3 call loads reflect_conv.cu."""
    from lama_tpu_torch.ops.kernels import _build
    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    from lama_tpu_torch.ops.kernels import conv3x3_wgmma as wg
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    calls = []
    launchers, load = (wg._launcher, sm._launcher), _build.load
    for mod, launcher in zip((wg, sm), launchers):
        monkeypatch.setattr(mod, '_launcher', lambda symbol, launcher=launcher:
                            calls.append(symbol) or launcher(symbol))
    monkeypatch.setattr(_build, 'load',
                        lambda name: calls.append(name) or load(name))
    g = torch.Generator().manual_seed(9)
    for fn, c, co, symbol, fp32 in (
            (rc.reflect_conv3x3_cols, 128, 128, 'lama_conv3x3_wgmma',
             'lama_conv3x3_simt'),
            (rc.reflect_conv3x3_taps, 384, 128, 'lama_conv3x3_wgmma',
             'lama_conv3x3_simt'),
            (rc.reflect_down_conv3x3, 64, 128, 'lama_conv3x3_s2_wgmma',
             'lama_conv3x3_s2_simt'),
            (hc.halo_conv3x3_reflect, 512, 128, 'lama_conv3x3_wgmma',
             'lama_conv3x3_simt')):
        x = torch.rand(1, c, 16, 16, generator=g).to(device)
        wt = torch.rand(co, c, 3, 3, generator=g).to(device)
        calls.clear()
        fn(x.to(torch.bfloat16), wt)
        assert calls[0] == symbol and 'reflect_conv' not in calls, calls
        calls.clear()
        fn(x, wt)
        assert calls[0] == fp32 and 'reflect_conv' not in calls, calls
        assert 'halo_conv' not in calls and 'conv3x3_wgmma' not in calls, calls
    torch.cuda.synchronize()


@pytest.mark.parametrize('name,b,c,co,h,w,bias', [
    # kernel 4's four downsamples at their widths and input sides
    ('reflect_down_conv3x3', 1, 64, 128, 512, 512, False),
    ('reflect_down_conv3x3', 1, 128, 256, 256, 256, False),
    ('reflect_down_conv3x3', 2, 256, 128, 128, 128, False),
    ('reflect_down_conv3x3', 2, 256, 384, 128, 128, True),
    # kernel 6: the served block, the train block, the tiny odd shape
    ('halo_conv3x3_reflect', 4, 512, 512, 64, 64, True),
    ('halo_conv3x3_reflect', 10, 512, 512, 32, 32, False),
    ('halo_conv3x3_reflect', 2, 24, 40, 37, 29, True),
])
def test_conv3x3_simt_fp32_main_shapes(device, name, b, c, co, h, w, bias):
    """The fp32 SIMT kernel through kernel 4's and kernel 6's wrappers at
    their main-path shapes, against the plain version."""
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    fn = getattr(rc if 'down' in name else hc, name)
    stride = 2 if 'down' in name else 1
    g = torch.Generator().manual_seed(c + co + h)
    x = torch.rand(b, c, h, w, generator=g).to(device)
    wt = ((torch.rand(co, c, 3, 3, generator=g) * 2 - 1)
          * (c * 9) ** -0.5).to(device)
    bb = torch.rand(co, generator=g).to(device) if bias else None
    ref = rc.reflect_conv_plain(x, wt, bb, stride)
    before = fn.launches
    out = fn(x, wt, bb)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out, ref, torch.float32)


@pytest.mark.parametrize('stride,b,c,co,h,w,bias', [
    (1, 2, 3, 5, 9, 13, True),         # C % 4: 4-byte copies
    (1, 1, 1, 1, 2, 2, False),         # the smallest input
    (1, 2, 40, 136, 19, 21, True),     # C % 16, C_out % 128, H, W % 8, 16
    (1, 1, 130, 7, 17, 33, False),     # C_out % 4: element stores
    (2, 2, 20, 130, 18, 10, True),     # C % 8, two N tiles, partial tiles
    (2, 1, 3, 8, 9, 13, False),        # odd sides: (H - 1) // 2 + 1 rows
    (2, 2, 96, 136, 34, 66, False),
])
def test_conv3x3_simt_any_widths(device, stride, b, c, co, h, w, bias):
    """The fp32 SIMT kernel launched directly at both strides outside the
    wrappers' shapes: channel tails by the copies' zero fill, element
    copies and stores, partial tiles, odd sides."""
    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    g = torch.Generator().manual_seed(c + co)
    x = torch.rand(b, c, h, w, generator=g).to(device)
    wt = ((torch.rand(co, c, 3, 3, generator=g) * 2 - 1)
          * (c * 9) ** -0.5).to(device)
    bb = torch.rand(co, generator=g).to(device) if bias else None
    ref = rc.reflect_conv_plain(x, wt, bb, stride)
    out = sm.conv3x3_reflect_fp32(
        x.contiguous(memory_format=torch.channels_last), wt, bb, stride)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out, ref, torch.float32)


def test_3x3_call_without_a_route_raises(device):
    """reflect_conv.py's launch has no fallback: a dtype with no route
    raises instead of reaching reflect_conv.cu."""
    from lama_tpu_torch.ops.kernels import conv3x3_wgmma as wg
    x = torch.rand(1, 128, 16, 16, device=device)
    wt = torch.rand(128, 128, 3, 3, device=device)
    with pytest.raises(TypeError, match='no kernel for torch.float32'):
        rc._launch('reflect_conv3x3_cols', rc.reflect_conv3x3_cols_supported,
                   x, wt, None, bf16=wg.conv3x3_reflect_bf16)


# kernels 2 and 3 where conv3x3_simt.py's plan splits K on an H100 (132
# SMs): the train bottleneck (b10 32^2) and the refiner's 125x95 and 63x48
# (batch 1), and one l2g shape of 1.8 waves (unsplit)
SPLIT_SHAPES = [
    ('reflect_conv3x3_cols', 10, 128, 128, 32, 32, 3),
    ('reflect_conv3x3_taps', 10, 384, 128, 32, 32, 3),
    ('reflect_conv3x3_taps', 10, 128, 384, 32, 32, 1),
    ('reflect_conv3x3_cols', 1, 128, 128, 125, 95, 4),
    ('reflect_conv3x3_taps', 1, 384, 128, 125, 95, 4),
    ('reflect_conv3x3_cols', 1, 128, 128, 63, 48, 4),
    ('reflect_conv3x3_taps', 1, 128, 384, 63, 48, 3),
    ('reflect_conv3x3_taps', 1, 384, 128, 63, 48, 4),
]


def _split_case(name, b, c, co, h, w, bias=False):
    g = torch.Generator().manual_seed(c + co + h)
    x = torch.rand(b, c, h, w, generator=g).cuda()
    wt = ((torch.rand(co, c, 3, 3, generator=g) * 2 - 1)
          * (c * 9) ** -0.5).cuda()
    bb = torch.rand(co, generator=g).cuda() if bias else None
    return x, wt, bb


@pytest.mark.parametrize('name,b,c,co,h,w,splits', SPLIT_SHAPES)
def test_fp32_cols_and_taps_at_the_split_shapes(device, name, b, c, co, h, w,
                                                splits):
    """fp32 cols and taps through their wrappers where the plan splits K
    (with a bias), against the plain version at fp32 TOL."""
    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    if sm.sm_count(device.index or 0) == 132:
        assert sm.plan_splits(b, h, w, c, co, 132) == splits
    x, wt, bb = _split_case(name, b, c, co, h, w, bias=True)
    ref = rc.reflect_conv_plain(x, wt, bb)
    fn = getattr(rc, name)
    before = fn.launches
    out = fn(x, wt, bb)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out, ref, torch.float32)


@pytest.mark.parametrize('name,b,c,co,h,w,splits',
                         [s for s in SPLIT_SHAPES if s[-1] > 1][::2])
def test_split_conv_is_bit_equal_run_to_run(device, name, b, c, co, h, w,
                                             splits):
    """The split's reduction sums in a fixed order: two calls of a split
    shape give the same bits."""
    x, wt, _ = _split_case(name, b, c, co, h, w)
    fn = getattr(rc, name)
    first = fn(x, wt)
    second = fn(x, wt)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize('b,c,co,h,w,splits,bias', [
    (2, 10, 5, 9, 13, 2, True),        # C % 4: element copies, 1 chunk a split
    (2, 40, 136, 19, 21, 3, True),     # 5 chunks in 1, 2, 2; two N tiles
    (1, 130, 7, 17, 33, 4, False),     # C_out % 4: the reduction's element stores
    (3, 64, 130, 10, 30, 2, True),     # C_out % 4 with a bias, three images
    (1, 24, 40, 37, 29, 3, True),      # kernel 6's tiny_odd, split anyway
])
def test_conv3x3_simt_forced_splits(device, b, c, co, h, w, splits, bias):
    """The stride-1 SIMT kernel at a split count given by the caller, any
    widths: runs of chunks that do not divide evenly, down to one chunk a
    split; channel and pixel tails; the reduction's element stores."""
    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    g = torch.Generator().manual_seed(c + co + splits)
    x = torch.rand(b, c, h, w, generator=g).to(device)
    wt = ((torch.rand(co, c, 3, 3, generator=g) * 2 - 1)
          * (c * 9) ** -0.5).to(device)
    bb = torch.rand(co, generator=g).to(device) if bias else None
    ref = rc.reflect_conv_plain(x, wt, bb)
    out = sm.conv3x3_reflect_fp32(
        x.contiguous(memory_format=torch.channels_last), wt, bb, 1, splits)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out, ref, torch.float32)


def test_conv3x3_simt_refuses_a_bad_split(device):
    """The launcher refuses more splits than chunks or than MAX_SPLITS, and
    any split at stride 2."""
    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    for c, stride, splits in ((16, 1, 3), (64, 1, sm.MAX_SPLITS + 1),
                              (64, 2, 2)):   # 2 chunks; 8 chunks
        x = torch.rand(1, c, 16, 16, device=device).contiguous(
            memory_format=torch.channels_last)
        wt = torch.rand(128, c, 3, 3, device=device)
        with pytest.raises(RuntimeError, match='CUDA launch failed'):
            sm.conv3x3_reflect_fp32(x, wt, None, stride, splits)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c,co,h,w,k,s,bias', [
    (4, 64, 64, 64, 7, 1, True),       # the generator's stem
    (4, 64, 37, 70, 7, 1, True),       # partial tiles
    (3, 5, 9, 13, 7, 2, False),        # odd sides: ceil(H / 2) outputs
    (6, 40, 20, 33, 3, 1, True),       # channel chunk and block tails
    (16, 32, 21, 18, 3, 2, True),
    (1, 1, 4, 4, 7, 1, False),         # the smallest input a pad of 3 takes
    (4, 80, 20, 20, 7, 1, True),       # two output-channel blocks
    # k * k * C > 256: bf16 takes the SIMT kernel too
    (32, 48, 19, 23, 3, 2, True),
    (8, 16, 30, 40, 7, 1, False),
])
def test_halo_conv_kernel(device, dtype, c, co, h, w, k, s, bias):
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    g = torch.Generator().manual_seed(5)
    x = torch.rand(2, c, h, w, generator=g).to(device)
    wt = ((torch.rand(co, c, k, k, generator=g) * 2 - 1)
          * (c * k * k) ** -0.5).to(device)
    b = torch.rand(co, generator=g).to(device) if bias else None
    ref = rc.reflect_conv_plain(x, wt, b, stride=s)
    before = hc.halo_conv_reflect_tiled.launches
    out = hc.halo_conv_reflect_tiled(x.to(dtype), wt, b, stride=s)
    torch.cuda.synchronize()
    assert hc.halo_conv_reflect_tiled.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    _close(out, ref, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,c,co,h,w,bias', [
    (4, 4, 64, 512, 512, False),       # big-lama's stem, served at b4
    (16, 4, 64, 512, 512, True),       # the served batch 16 (regular: bias)
    (10, 4, 64, 256, 256, False),      # training
    (1, 4, 64, 1024, 1024, False),     # the refiner's inputs
    (1, 4, 64, 1000, 760, True),
    (2, 4, 64, 37, 70, True),          # small odd sides, partial tiles
    (1, 3, 16, 4, 9, False),           # C = 3 (element path), H = 4
    (2, 8, 48, 13, 33, True),          # pitch 8, one-copy path, C_out 48
    (1, 6, 32, 19, 4, False),          # pitch 8, element path, W = 4
    (3, 1, 64, 9, 31, True),           # C = 1
])
def test_stem_conv_kernel(device, dtype, b, c, co, h, w, bias):
    """The 7x7 stride-1 stem on csrc/stem_conv.cu through kernel 7's
    wrapper, against the plain version at TOL, and bit-equal on a second
    call."""
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    from lama_tpu_torch.ops.kernels import stem_conv as sc
    assert hc.tiled_route(h, w, c, co, 7, 1) is sc.stem_conv_reflect
    g = torch.Generator().manual_seed(b + c + h)
    x = torch.rand(b, c, h, w, generator=g).to(device)
    wt = ((torch.rand(co, c, 7, 7, generator=g) * 2 - 1)
          * (c * 49) ** -0.5).to(device)
    bb = torch.rand(co, generator=g).to(device) if bias else None
    ref = rc.reflect_conv_plain(x, wt, bb)
    before = hc.halo_conv_reflect_tiled.launches
    out = hc.halo_conv_reflect_tiled(x.to(dtype), wt, bb)
    torch.cuda.synchronize()
    assert hc.halo_conv_reflect_tiled.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    _close(out, ref, dtype)
    assert torch.equal(hc.halo_conv_reflect_tiled(x.to(dtype), wt, bb), out)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,c,co,h,w,bias,misalign', [
    (4, 64, 3, 512, 512, True, False),     # the served head at b4
    (16, 64, 3, 512, 512, True, False),    # the served batch 16
    (10, 64, 3, 256, 256, True, False),    # training
    (1, 64, 3, 1000, 760, True, False),    # the refiner's inputs
    (2, 64, 3, 37, 70, False, True),       # a misaligned channels-last view
    (1, 24, 5, 11, 9, True, True),
    (3, 40, 2, 8, 8, False, False),        # the smallest sides, C % 16
])
def test_head_conv_kernel(device, dtype, b, c, co, h, w, bias, misalign):
    """The 7x7 head on csrc/reflect_conv.cu through its wrapper, against
    the plain version at TOL, bit-equal on a second call; a misaligned x
    (one element past a 16-byte boundary) takes the element copies."""
    g = torch.Generator().manual_seed(b + c + co + h)
    x = torch.rand(b, c, h, w, generator=g).to(device).to(dtype)
    if misalign:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=device)
        buf[1:] = x.permute(0, 2, 3, 1).reshape(-1)
        x = buf[1:].view(b, h, w, c).permute(0, 3, 1, 2)
        assert x.is_contiguous(memory_format=torch.channels_last)
        assert x.data_ptr() % 16
    wt = ((torch.rand(co, c, 7, 7, generator=g) * 2 - 1)
          * (c * 49) ** -0.5).to(device)
    bb = torch.rand(co, generator=g).to(device) if bias else None
    ref = rc.reflect_conv_plain(x.float(), wt, bb)
    before = rc.reflect_out_conv7x7.launches
    out = rc.reflect_out_conv7x7(x, wt, bb)
    torch.cuda.synchronize()
    assert rc.reflect_out_conv7x7.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    _close(out, ref, dtype)
    assert torch.equal(rc.reflect_out_conv7x7(x, wt, bb), out)


def test_stem_runs_stem_conv_and_other_shapes_halo_conv(device, monkeypatch):
    """Kernel 7's stem launches stem_conv.cu in both dtypes and loads no
    halo_conv.cu; its k3 s1, k3 s2 and k7 s2 shapes launch halo_conv.cu."""
    from lama_tpu_torch.ops.kernels import _build
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    from lama_tpu_torch.ops.kernels import stem_conv as sc
    calls = []
    launcher, load = sc._launcher, _build.load
    monkeypatch.setattr(sc, '_launcher',
                        lambda: calls.append('stem_conv') or launcher())
    monkeypatch.setattr(_build, 'load',
                        lambda name: calls.append(name) or load(name))
    g = torch.Generator().manual_seed(11)
    for c, co, k, s, want in ((4, 64, 7, 1, 'stem_conv'),
                              (16, 32, 3, 1, 'halo_conv'),
                              (32, 64, 3, 2, 'halo_conv'),
                              (8, 24, 7, 2, 'halo_conv')):
        x = torch.rand(1, c, 24, 40, generator=g).to(device)
        wt = torch.rand(co, c, k, k, generator=g).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            calls.clear()
            hc.halo_conv_reflect_tiled(x.to(dtype), wt, stride=s)
            assert calls[0] == want, (c, co, k, s, dtype, calls)
            assert ('halo_conv' in calls) == (want == 'halo_conv'), calls
    torch.cuda.synchronize()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,c,co,h,w,bias', [
    (2, 512, 512, 32, 32, True),       # the GlobalGenerator's block convs
    (2, 512, 512, 13, 11, False),      # partial tiles
    (2, 64, 64, 16, 16, True),
    (2, 24, 40, 37, 29, True),         # channel chunk and block tails
    (1, 3, 5, 2, 9, False),            # the smallest input a pad of 1 takes
    (2, 8, 8, 16, 16, False),
    # the bf16 wgmma kernel's edges: 16x16-pixel tiles, 32-channel chunks,
    # 128-channel output tiles, 8-channel copies
    (2, 40, 136, 19, 21, True),        # C % 32, C_out % 128, H, W % 16
    (2, 1, 8, 17, 33, True),           # C = 1
    (1, 1, 1, 2, 2, False),
    (2, 12, 20, 31, 47, False),        # C % 8: element loads
    (2, 96, 256, 16, 16, False),       # whole tiles: 3 chunks x 2 N tiles
    (16, 512, 512, 64, 64, True),      # big-lama-regular's served batch
])
def test_halo_conv3x3_kernel(device, dtype, b, c, co, h, w, bias):
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    g = torch.Generator().manual_seed(7)
    x = torch.rand(b, c, h, w, generator=g).to(device)
    wt = ((torch.rand(co, c, 3, 3, generator=g) * 2 - 1)
          * (c * 9) ** -0.5).to(device)
    bb = torch.rand(co, generator=g).to(device) if bias else None
    ref = hc.halo_conv3x3_reflect_plain(x, wt, bb)
    before = hc.halo_conv3x3_reflect.launches
    out = hc.halo_conv3x3_reflect(x.to(dtype), wt, bb)
    torch.cuda.synchronize()
    assert hc.halo_conv3x3_reflect.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    _close(out, ref, dtype)


def _fourier_unit_case(device, b, c, co, h, w):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(b, c, h, w, generator=g).to(device)
    args = [((torch.rand(2 * co, 2 * c, 1, 1, generator=g) * 2 - 1) * 0.1),
            1 + 0.2 * torch.rand(2 * co, generator=g),
            0.1 * torch.rand(2 * co, generator=g),
            0.1 * torch.rand(2 * co, generator=g),
            1 + 0.3 * torch.rand(2 * co, generator=g)]
    return x, [a.to(device) for a in args]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,c,co,h,w', [(2, 192, 192, 16, 16),
                                        (1, 8, 4, 12, 10),
                                        # odd sides, as the refiner's bottleneck
                                        # at 1000x760 (125x95) and 504x384 (63x48)
                                        (1, 192, 192, 125, 95),
                                        (1, 8, 4, 63, 48), (2, 16, 16, 13, 11),
                                        # the 1024^2 refine scale's, 128x128
                                        (1, 16, 16, 128, 128),
                                        # the served batch
                                        (16, 192, 192, 64, 64),
                                        # the LFU unit of an ffc_positions
                                        # block at the served batch
                                        (16, 192, 192, 32, 32),
                                        # C % 4 != 0: 4-byte copies (fp32)
                                        # and element loads (bf16)
                                        (2, 6, 10, 13, 11),
                                        # C % 8 != 0: bf16's element loads
                                        (1, 12, 20, 20, 18)])
def test_fourier_unit_kernel(device, dtype, b, c, co, h, w):
    x, args = _fourier_unit_case(device, b, c, co, h, w)
    ref = fu.fourier_unit_plain(x, *args)
    before = fu.fused_fourier_unit.launches
    out = fu.fused_fourier_unit(x.to(dtype), *args)
    torch.cuda.synchronize()
    assert fu.fused_fourier_unit.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out, ref, dtype)


@pytest.mark.parametrize('norm', ['backward', 'forward'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,c,co,h,w', [(16, 192, 192, 64, 64),
                                        (1, 16, 16, 125, 95)])
def test_fourier_unit_kernel_with_norm(device, dtype, norm, b, c, co, h, w):
    """The other norms' twiddle tables, against the plain unit of that
    norm."""
    x, args = _fourier_unit_case(device, b, c, co, h, w)
    ref = fu.fourier_unit_plain(x, *args, norm=norm)
    before = fu.fused_fourier_unit.launches
    out = fu.fused_fourier_unit(x.to(dtype), *args, norm=norm)
    torch.cuda.synchronize()
    assert fu.fused_fourier_unit.launches == before + 1
    _close(out, ref, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fourier_unit_past_256_takes_cufft(device, dtype):
    """A (1, 192, 320, 320) eval unit runs fourier_unit_fft (cuFFT), no
    kernel-1 launch, and matches its CPU run."""
    from lama_tpu_torch.models.ffc import FourierUnit
    unit = FourierUnit(192, 192).eval()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        unit.bn.running_mean.copy_(0.1 * torch.rand(384, generator=g))
        unit.bn.running_var.copy_(1 + 0.3 * torch.rand(384, generator=g))
    x = torch.rand(1, 192, 320, 320, generator=g)
    with torch.no_grad():
        ref = unit(x)
        launches, calls = fu.fused_fourier_unit.launches, \
            fu.fourier_unit_fft.calls
        out = unit.to(device)(x.to(device, dtype))
        torch.cuda.synchronize()
    assert fu.fused_fourier_unit.launches == launches
    assert fu.fourier_unit_fft.calls == calls + 1
    assert out.dtype == dtype
    _close(out.float().cpu(), ref, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fourier_unit_is_bit_equal_run_to_run(device, dtype):
    """No atomics and a fixed summation order: two calls on the same
    inputs give the same bits."""
    x, args = _fourier_unit_case(device, 4, 192, 192, 64, 64)
    first = fu.fused_fourier_unit(x.to(dtype), *args)
    second = fu.fused_fourier_unit(x.to(dtype), *args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize('h,w', [(128, 128), (256, 256), (127, 128),
                                 (64, 64), (125, 95)])
def test_irfft2_of_a_non_hermitian_spectrum_on_the_card(device, h, w):
    """The plain FourierUnit's inverse on the card equals the CPU's (numpy's
    semantics): cuFFT's one-call 2-D C2R transform differed at W = 128 and
    256 for such spectra."""
    from lama_tpu_torch.ops import spectral
    g = torch.Generator().manual_seed(h + w)
    re, im = (torch.randn(1, 4, h, w // 2 + 1, generator=g) for _ in range(2))
    ref = spectral.irfft2(re, im, s=(h, w))
    out = spectral.irfft2(re.to(device), im.to(device), s=(h, w))
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-5)


def _grad_close(ours, ref):
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        atol = 1e-5 * float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)


@pytest.mark.parametrize('name,c,co,h,k,bias', [
    ('reflect_conv3x3_cols', 128, 128, 16, 3, True),
    ('reflect_conv3x3_taps', 128, 384, 16, 3, False),
    ('reflect_down_conv3x3', 64, 128, 32, 3, True),
    ('reflect_down_conv3x3', 256, 384, 32, 3, False),
    ('reflect_out_conv7x7', 64, 3, 24, 7, True),
    ('reflect_out_conv7x7', 128, 8, 20, 7, False),
])
def test_reflect_conv_gradients(device, name, c, co, h, k, bias):
    g = torch.Generator().manual_seed(3)
    stride = 2 if 'down' in name else 1
    x = torch.rand(2, c, h, h, generator=g).to(device).requires_grad_()
    wt = ((torch.rand(co, c, k, k, generator=g) * 2 - 1)
          * (c * k * k) ** -0.5).to(device).requires_grad_()
    b = (torch.rand(co, generator=g).to(device).requires_grad_() if bias
         else None)
    r = torch.rand(2, co, h // stride, h // stride, generator=g).to(device)
    inputs = [t for t in (x, wt, b) if t is not None]
    fn = getattr(rc, name)
    before = fn.launches
    ours = torch.autograd.grad((fn(x, wt, b) * r).sum(), inputs)
    assert fn.launches == before + 1
    ref = torch.autograd.grad(
        (rc.reflect_conv_plain(x, wt, b, stride) * r).sum(), inputs)
    _grad_close(ours, ref)


@pytest.mark.parametrize('k,s', [(7, 1), (3, 2)])
def test_halo_conv_gradients(device, k, s):
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    g = torch.Generator().manual_seed(6)
    x = torch.rand(2, 4, 32, 32, generator=g).to(device).requires_grad_()
    wt = ((torch.rand(64, 4, k, k, generator=g) * 2 - 1)
          * (4 * k * k) ** -0.5).to(device).requires_grad_()
    b = torch.rand(64, generator=g).to(device).requires_grad_()
    r = torch.rand(2, 64, 32 // s, 32 // s, generator=g).to(device)
    before = hc.halo_conv_reflect_tiled.launches
    ours = torch.autograd.grad(
        (hc.halo_conv_reflect_tiled(x, wt, b, stride=s) * r).sum(), [x, wt, b])
    assert hc.halo_conv_reflect_tiled.launches == before + 1
    ref = torch.autograd.grad(
        (rc.reflect_conv_plain(x, wt, b, s) * r).sum(), [x, wt, b])
    _grad_close(ours, ref)


@pytest.mark.parametrize('c,co,h', [(512, 512, 16), (24, 40, 13),
                                    (512, 512, 32), (3, 5, 9)])
def test_halo_conv3x3_gradients(device, c, co, h):
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    g = torch.Generator().manual_seed(8)
    x = torch.rand(2, c, h, h, generator=g).to(device).requires_grad_()
    wt = ((torch.rand(co, c, 3, 3, generator=g) * 2 - 1)
          * (c * 9) ** -0.5).to(device).requires_grad_()
    b = torch.rand(co, generator=g).to(device).requires_grad_()
    r = torch.rand(2, co, h, h, generator=g).to(device)
    before = hc.halo_conv3x3_reflect.launches
    ours = torch.autograd.grad(
        (hc.halo_conv3x3_reflect(x, wt, b) * r).sum(), [x, wt, b])
    assert hc.halo_conv3x3_reflect.launches == before + 1
    ref = torch.autograd.grad(
        (hc.halo_conv3x3_reflect_plain(x, wt, b) * r).sum(), [x, wt, b])
    _grad_close(ours, ref)


def test_fourier_unit_gradients(device):
    g = torch.Generator().manual_seed(4)
    c = co = 16
    x = torch.rand(2, c, 16, 16, generator=g).to(device).requires_grad_()
    params = [((torch.rand(2 * co, 2 * c, 1, 1, generator=g) * 2 - 1) * 0.1),
              1 + 0.2 * torch.rand(2 * co, generator=g),
              0.1 * torch.rand(2 * co, generator=g)]
    params = [p.to(device).requires_grad_() for p in params]
    stats = [0.1 * torch.rand(2 * co, generator=g).to(device),
             (1 + 0.3 * torch.rand(2 * co, generator=g)).to(device)]
    r = torch.rand(2, co, 16, 16, generator=g).to(device)
    before = fu.fused_fourier_unit.launches
    ours = torch.autograd.grad(
        (fu.fused_fourier_unit(x, *params, *stats) * r).sum(), [x] + params)
    assert fu.fused_fourier_unit.launches == before + 1
    ref = torch.autograd.grad(
        (fu.fourier_unit_plain(x, *params, *stats) * r).sum(), [x] + params)
    _grad_close(ours, ref)


def test_generator_kernels_match_plain(device):
    from lama_tpu_torch.models import make_generator
    # ngf 64 gives the bottleneck big-lama's 128 local / 384 global channels,
    # so every kernel runs
    kw = dict(input_nc=4, output_nc=3, ngf=64, n_downsampling=3, n_blocks=1,
              add_out_act='sigmoid',
              init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0,
                                    enable_lfu=False),
              downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0,
                                          enable_lfu=False),
              resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75,
                                      enable_lfu=False))
    plain = make_generator('ffc_resnet', kernels='plain', **kw).eval()
    ours = make_generator('ffc_resnet', **kw).eval()
    ours.load_state_dict(plain.state_dict())
    x = torch.rand(2, 4, 128, 128, generator=torch.Generator().manual_seed(2))
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    fns = (rc.reflect_conv3x3_cols, rc.reflect_conv3x3_taps,
           fu.fused_fourier_unit, rc.reflect_out_conv7x7,
           rc.reflect_down_conv3x3, hc.halo_conv_reflect_tiled,
           hc.halo_conv3x3_reflect)
    before = [fn.launches for fn in fns]
    with torch.inference_mode():
        ref = plain.to(device)(x.to(device))
        out = ours.to(device)(x.to(device))
    after = [fn.launches for fn in fns]
    # kernel 6 takes no conv of the FFC generator
    assert [a - b for a, b in zip(after, before)] == [2, 4, 2, 1, 4, 1, 0]
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_global_generator_kernels_match_plain(device):
    """A GlobalGenerator at the family's widths (ngf 64, 3 downsamplings:
    512-channel blocks), one block: kernels 5, 6 and 7 run, the others
    not."""
    from lama_tpu_torch.models import make_generator
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    kw = dict(input_nc=4, output_nc=3, ngf=64, n_downsampling=3, n_blocks=1,
              add_out_act='sigmoid')
    plain = make_generator('pix2pixhd_global', kernels='plain', **kw).eval()
    ours = make_generator('pix2pixhd_global', **kw).eval()
    ours.load_state_dict(plain.state_dict())
    x = torch.rand(2, 4, 128, 128, generator=torch.Generator().manual_seed(2))
    fns = (rc.reflect_conv3x3_cols, rc.reflect_conv3x3_taps,
           fu.fused_fourier_unit, rc.reflect_out_conv7x7,
           rc.reflect_down_conv3x3, hc.halo_conv_reflect_tiled,
           hc.halo_conv3x3_reflect)
    before = [fn.launches for fn in fns]
    with torch.inference_mode():
        ref = plain.to(device)(x.to(device))
        out = ours.to(device)(x.to(device))
    after = [fn.launches for fn in fns]
    assert [a - b for a, b in zip(after, before)] == [0, 0, 0, 1, 0, 1, 2]
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_multidilated_generator_kernels_match_plain(device, dtype):
    """configs/training/ablv2_work_md.yaml's generator at its widths (ngf
    64, 3 downsamplings, cat_in over dilations 1, 2, 4, 8: 128 -> 512 a
    branch), one block: the dilation-1 branches on kernel 3 (2), the stem
    and the head on kernels 7 and 5, the dilated branches, downsamples and
    ConvTranspose layers on cuDNN; fp32 within 1e-4 of the plain
    generator, bf16 within the kernels' 2e-2 of the fp32 plain one."""
    from lama_tpu_torch.models import make_generator
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    kw = dict(input_nc=4, output_nc=3, ngf=64, n_downsampling=3, n_blocks=1,
              add_out_act='sigmoid',
              multidilation_kwargs=dict(comb_mode='cat_in', dilation_num=4))
    plain = make_generator('pix2pixhd_multidilated', kernels='plain',
                           **kw).eval()
    ours = make_generator('pix2pixhd_multidilated', dtype=dtype, **kw).eval()
    ours.load_state_dict(plain.state_dict())
    x = torch.rand(2, 4, 128, 128, generator=torch.Generator().manual_seed(2))
    fns = (rc.reflect_conv3x3_cols, rc.reflect_conv3x3_taps,
           fu.fused_fourier_unit, rc.reflect_out_conv7x7,
           rc.reflect_down_conv3x3, hc.halo_conv_reflect_tiled,
           hc.halo_conv3x3_reflect)
    before = [fn.launches for fn in fns]
    with torch.inference_mode():
        ref = plain.to(device)(x.to(device))
        out = ours.to(device)(x.to(device))
    after = [fn.launches for fn in fns]
    assert [a - b for a, b in zip(after, before)] == [0, 2, 0, 1, 0, 1, 0]
    _close(out, ref, dtype)


def test_ffc_positions_generator_kernels_match_plain(device):
    """A GlobalGenerator with an inline FFC block (LFU on) before its one
    ResnetBlock, at the family's widths: l2l on kernel 2, l2g and g2l on
    kernel 3, the g2g FourierUnit and the LFU's on kernel 1, the
    ResnetBlock on kernel 6, fp32 against the plain generator."""
    from lama_tpu_torch.models import make_generator
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    kw = dict(input_nc=4, output_nc=3, ngf=64, n_downsampling=3, n_blocks=1,
              add_out_act='sigmoid', ffc_positions=[0])
    plain = make_generator('pix2pixhd_global', kernels='plain', **kw).eval()
    ours = make_generator('pix2pixhd_global', **kw).eval()
    ours.load_state_dict(plain.state_dict())
    x = torch.rand(2, 4, 128, 128, generator=torch.Generator().manual_seed(3))
    fns = (rc.reflect_conv3x3_cols, rc.reflect_conv3x3_taps,
           fu.fused_fourier_unit, rc.reflect_out_conv7x7,
           rc.reflect_down_conv3x3, hc.halo_conv_reflect_tiled,
           hc.halo_conv3x3_reflect)
    before = [fn.launches for fn in fns]
    with torch.inference_mode():
        ref = plain.to(device)(x.to(device))
        out = ours.to(device)(x.to(device))
    after = [fn.launches for fn in fns]
    assert [a - b for a, b in zip(after, before)] == [2, 4, 4, 1, 0, 1, 2]
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- the scores
# each score on the card against its own CPU run on the same inputs; TF32
# is switched on around the calls, and the scores must turn it off
# (evaluation/utils.py::no_tf32): SSIM atol 1e-6, the nets rtol 1e-3 /
# atol 2e-4, as the CPU tests hold them to lama_tpu

def _score_inputs(n=4, h=96, w=128, seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / 11.0
    target = np.stack([np.clip(0.5 + 0.4 * np.sin(yy + i) * np.cos(xx - i)
                               + 0.05 * rng.randn(h, w), 0, 1)
                       for i in range(n * 3)]).reshape(n, 3, h, w)
    target = target.transpose(0, 2, 3, 1).astype(np.float32)
    pred = np.clip(target + 0.1 * rng.randn(*target.shape), 0, 1)
    return pred.astype(np.float32), target


@contextlib.contextmanager
def _tf32_on():
    """TF32 on for cuBLAS and cuDNN around a score call, which must turn it
    off for itself and put it back: the flags read True again after the
    call, and the values from before the block are restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize('name', ['ssim', 'lpips'])
def test_pairwise_score_on_the_card_matches_cpu(device, name):
    import numpy as np
    from lama_tpu_torch.evaluation.scores import LPIPSScore, SSIMScore
    cls = SSIMScore if name == 'ssim' else LPIPSScore
    pred, target = _score_inputs()
    cpu = cls(device='cpu')(pred, target)
    with _tf32_on():
        card = cls(device=device)(pred, target)
    if name == 'ssim':
        np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(card, cpu, rtol=1e-3, atol=2e-4)


def test_inception_activations_on_the_card_match_cpu(device):
    import numpy as np
    from lama_tpu_torch.evaluation.fid import InceptionActivations
    pred, _ = _score_inputs(n=3)
    cpu = InceptionActivations(device='cpu', seed=0)(pred)
    with _tf32_on():
        card = InceptionActivations(device=device, seed=0)(pred)
    assert card.shape == (3, 2048)
    np.testing.assert_allclose(card, cpu, rtol=1e-3, atol=2e-4)
    assert np.abs(cpu).max() > 0.1


@pytest.mark.parametrize('arch', ['resnet50dilated', 'mobilenetv2dilated'])
def test_segmenter_on_the_card_matches_cpu(device, arch):
    """The ADE20k segmenter (seeded random weights, BatchNorm statistics
    from one train-mode forward on the inputs) on the card against its own
    CPU run on the same weights, with TF32 on around the call (the
    segmenter turns it off): class scores within atol 2e-4 and summing to
    1, labels equal wherever the top two scores differ by more than twice
    the largest score difference (at most 3% of the pixels are such
    near-ties: calibrated, the softmax is flat, its top score ~0.05)."""
    import numpy as np
    from lama_tpu_torch.models.aux.random_init import calibrate_batchnorm_
    from lama_tpu_torch.models.aux.segmentation import SegmentationModule
    pred, _ = _score_inputs(n=2, h=96, w=128)
    cpu = SegmentationModule(arch_encoder=arch, device='cpu')
    calibrate_batchnorm_(cpu.net, cpu._input(pred))
    cpu_labels, cpu_scores = cpu.predict(pred)
    with _tf32_on():
        labels, scores = SegmentationModule(
            arch_encoder=arch, device=device,
            state_dict=cpu.net.state_dict()).predict(pred)
    assert scores.is_cuda and scores.shape == (2, 150, 96, 128)
    scores, cpu_scores = scores.cpu().numpy(), cpu_scores.numpy()
    np.testing.assert_allclose(scores, cpu_scores, rtol=0, atol=2e-4)
    np.testing.assert_allclose(scores.sum(1), 1, atol=1e-5)
    top2 = np.sort(cpu_scores, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * np.abs(scores - cpu_scores).max()
    assert clear.mean() >= 0.97
    np.testing.assert_array_equal(labels[clear], cpu_labels[clear])
    assert len(np.unique(cpu_labels)) > 3


# ------------------------------------------------ the rest of training
# The FFC discriminator's reflect convs run kernels 6 (L0, L4) and 4 (L1-L3)
# and its R1 penalty differentiates them twice (_autograd._PlainVJP): the
# penalty and the D loss's weight gradient, kernels vs plain, on the same
# weights and batch. The gradient crosses leaky-ReLU gates after
# train-mode BN, so it is held by norms: fp32 ||d|| / ||g|| <= 1e-3 and
# cosine >= 1 - 1e-6; bf16 (bf16 operands on both sides, different
# accumulation) ||d|| / ||g|| <= 5e-2 and cosine >= 0.998.
FFC_D_GRAD_TOL = {torch.float32: (1e-3, 1e-6), torch.bfloat16: (5e-2, 2e-3)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_ffc_discriminator_r1_gradient_kernels_match_plain(device, dtype):
    from lama_tpu_torch.losses.adversarial import make_discrim_loss
    from lama_tpu_torch.models import make_discriminator
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    kw = dict(input_nc=3, ndf=64, n_layers=4, dtype=dtype)
    plain = make_discriminator('ffc_nlayer', kernels='plain', **kw)
    ours = make_discriminator('ffc_nlayer', **kw)
    ours.load_state_dict(plain.state_dict())
    plain, ours = plain.to(device).train(), ours.to(device).train()
    g = torch.Generator().manual_seed(4)
    img, fake = (torch.rand(2, 3, 64, 64, generator=g).to(device)
                 for _ in range(2))
    mask = (torch.rand(2, 1, 64, 64, generator=g) > 0.5).float().to(device)
    loss_fn = make_discrim_loss('r1', weight=10, gp_coef=0.001,
                                mask_as_fake_target=True, allow_scale_mask=True)

    def run(model):
        real = img.clone().requires_grad_(True)
        score, _ = model(real)
        gp = loss_fn.r1_penalty(score, real)
        fake_score, _ = model(fake)
        loss, _ = loss_fn.discriminator_loss(score.float(), fake_score.float(),
                                             gp, mask)
        return gp.detach(), torch.autograd.grad(loss, list(model.parameters()))

    before = (hc.halo_conv3x3_reflect.launches, rc.reflect_down_conv3x3.launches)
    gp, grads = run(ours)
    assert (hc.halo_conv3x3_reflect.launches - before[0],
            rc.reflect_down_conv3x3.launches - before[1]) == (4, 6)
    ref_gp, ref = run(plain)
    assert float(ref_gp) > 0
    rtol = 1e-4 if dtype == torch.float32 else 5e-2
    assert abs(float(gp) - float(ref_gp)) <= rtol * float(ref_gp)
    a = torch.cat([t.flatten().double() for t in grads])
    b = torch.cat([t.flatten().double() for t in ref])
    rel, cos_tol = FFC_D_GRAD_TOL[dtype]
    assert float((a - b).norm() / b.norm()) <= rel
    assert float(torch.nn.functional.cosine_similarity(a, b, 0)) >= 1 - cos_tol


def test_ablv2_vgg_train_step_on_the_card(device, tmp_path):
    """One step of `python -m lama_tpu_torch.train -cn
    ablv2_work_no_segmpl_vgg` as shipped (the GlobalGenerator of 9 blocks,
    the VGG19 perceptual loss at 0.03, random weights), b2 128^2, bf16: its
    losses finite, gen_pl non-zero, kernel 6 36 times, the stem and the
    head twice."""
    import json

    import cv2
    import numpy as np

    from lama_tpu_torch import train as port_train
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    os.makedirs(tmp_path / 'data' / 'train')
    rng = np.random.RandomState(0)
    for i in range(2):
        cv2.imwrite(str(tmp_path / 'data' / 'train' / f'{i}.jpg'),
                    (rng.rand(160, 160, 3) * 255).astype(np.uint8))
    fns = (hc.halo_conv3x3_reflect, hc.halo_conv_reflect_tiled,
           rc.reflect_out_conv7x7)
    before = [fn.launches for fn in fns]
    port_train.main('ablv2_work_no_segmpl_vgg', [
        f'location.data_root_dir={tmp_path / "data"}',
        f'location.out_root_dir={tmp_path}', f'run_dir={tmp_path / "run"}',
        'data.batch_size=2', 'data.train.out_size=128', 'data.num_workers=1',
        'trainer.kwargs.max_epochs=1', 'trainer.kwargs.limit_train_batches=1',
        'trainer.kwargs.log_every_n_steps=1',
        'training_model.visualize_each_iters=0', 'device=cuda'])
    counts = [fn.launches - b for fn, b in zip(fns, before)]
    assert counts == [36, 2, 2]
    line = json.loads(open(tmp_path / 'run' / 'metrics.jsonl').readline())
    assert all(np.isfinite(v) for v in line.values())
    assert line['gen_pl'] != 0


# ---------------------------------------------------------- int8 serving
# the int8 conv (csrc/conv_int8.cu) against ops/quant.py's plain version on
# the card: the int32 sums bit-equal (the plain version sums exactly in
# float64), the outputs within the fp32 epilogue's rounding (rtol 1e-6 of
# the largest |output|; one rounding an operation in both, so equal in
# practice); and the FourierUnit's store_bf16 against its plain version


def _int8_case(device, b, c, co, h, w, k, dtype, channels_last, transposed,
               seed=3):
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(b, c, h, w, generator=g) * 2 - 1).to(device, dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    shape = (c, co, k, k) if transposed else (co, c, k, k)
    weight = ((torch.rand(*shape, generator=g) * 2 - 1)
              * (c * k * k) ** -0.5).to(device)
    bias = (torch.rand(co, generator=g) * 0.2 - 0.1).to(device)
    return x, weight, bias


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,c,co,h,w,k,stride,mode,zero_pad,cl,static', [
    # big-lama's convs at 16^2: l2l, l2g, g2l, the SpectralTransform's 1x1
    (2, 128, 128, 16, 16, 3, 1, 'reflect', False, True, False),
    (2, 128, 384, 16, 16, 3, 1, 'reflect', False, True, True),
    (2, 384, 128, 16, 16, 3, 1, 'reflect', True, True, False),
    (2, 384, 192, 16, 16, 1, 1, 'zeros', False, True, False),
    (2, 192, 384, 16, 16, 1, 1, 'zeros', False, False, True),
    # the downsamples (reflect; the GlobalGenerator's zero-padded), odd sides
    (2, 64, 128, 37, 30, 3, 2, 'reflect', False, True, False),
    (1, 256, 512, 16, 18, 3, 2, 'zeros', False, True, False),
    # the GlobalGenerator's block conv, channel tails past C and C_out
    (2, 512, 512, 8, 8, 3, 1, 'reflect', False, True, False),
    (1, 40, 72, 9, 11, 3, 1, 'reflect', False, False, False),
])
def test_int8_conv_kernel(device, dtype, b, c, co, h, w, k, stride, mode,
                          zero_pad, cl, static):
    from lama_tpu_torch.ops import quant
    from lama_tpu_torch.ops.kernels import conv_int8 as ci
    x, weight, bias = _int8_case(device, b, c, co, h, w, k, dtype, cl, False)
    amax = x.float().abs().amax() * 0.75 if static else None
    pad = k // 2
    plan = ci.conv_plan(x.shape, weight.shape, stride, pad, 1, 1, mode,
                        zero_pad)
    packed, s_w = ci.pack_weight(weight)
    xq, amax_t = ci.quantize_activation(x, amax)
    acc = ci.conv_codes(xq, amax_t, packed, s_w, None, plan, co, 'acc')
    s_x = quant.act_scale(x, amax)
    wq, _ = quant.quantize_weight(weight)
    ref_acc = quant.conv2d_acc(quant.quantize(x, s_x), wq, stride, pad, 1, 1,
                               mode, zero_pad)
    torch.cuda.synchronize()
    assert torch.equal(acc, ref_acc)
    before = ci.quantized_conv2d.launches
    with torch.no_grad():
        out = ci.quantized_conv2d(x, weight, bias, stride, pad, 1, 1, mode,
                                  act_amax=amax, zero_pad=zero_pad)
        ref = quant.quantized_conv2d(x, weight, bias, stride, pad, 1, 1,
                                     mode, act_amax=amax, zero_pad=zero_pad)
    torch.cuda.synchronize()
    assert ci.quantized_conv2d.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    scale = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,c,co,h,w,stride,padding,output_padding', [
    (2, 512, 256, 8, 8, 2, 1, 1), (1, 128, 64, 13, 10, 2, 1, 1),
    (1, 64, 40, 5, 4, 2, 0, 0), (1, 64, 40, 5, 4, 1, 1, 0)])
def test_int8_conv_transpose_kernel(device, dtype, b, c, co, h, w, stride,
                                    padding, output_padding):
    from lama_tpu_torch.ops import quant
    from lama_tpu_torch.ops.kernels import conv_int8 as ci
    x, weight, bias = _int8_case(device, b, c, co, h, w, 3, dtype, True, True)
    plan = ci.conv_transpose_plan(x.shape, weight.shape, stride, padding,
                                  output_padding)
    packed, s_w = ci.pack_weight(weight, transposed=True)
    xq, amax = ci.quantize_activation(x)
    acc = ci.conv_codes(xq, amax, packed, s_w, None, plan, co, 'acc')
    wq, _ = quant.quantize_weight(weight, transposed=True)
    ref_acc = quant.conv_transpose2d_acc(
        quant.quantize(x, quant.act_scale(x)), wq, stride, padding,
        output_padding)
    torch.cuda.synchronize()
    assert torch.equal(acc, ref_acc)
    with torch.no_grad():
        out = ci.quantized_conv_transpose2d(x, weight, bias, stride, padding,
                                            output_padding)
        ref = quant.quantized_conv_transpose2d(x, weight, bias, stride,
                                               padding, output_padding)
    torch.cuda.synchronize()
    scale = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_int8_conv_refuses_gradients_and_dilation(device, dtype):
    """A gradient is refused; a dilated conv (the multidilated branches'
    128 -> 512 at dilations 2, 4 and 8, reflect, zero and zero_pad borders,
    and stride 2 at dilation 2) runs, its int32 sums bit-equal to the
    plain version's."""
    from lama_tpu_torch.ops import quant
    from lama_tpu_torch.ops.kernels import conv_int8 as ci
    x, weight, _ = _int8_case(device, 1, 64, 64, 8, 8, 3, torch.float32,
                              True, False)
    with pytest.raises(RuntimeError, match='gradient'):
        ci.quantized_conv2d(x, weight.requires_grad_(), None, 1, 1)
    for d, stride, mode, zero_pad in ((2, 1, 'reflect', False),
                                      (4, 1, 'reflect', False),
                                      (8, 1, 'reflect', False),
                                      (8, 1, 'reflect', True),
                                      (8, 1, 'zeros', False),
                                      (2, 2, 'reflect', False)):
        x, weight, bias = _int8_case(device, 2, 128, 512, 16, 16, 3, dtype,
                                     True, False, seed=d + stride)
        plan = ci.conv_plan(x.shape, weight.shape, stride, d, d, 1, mode,
                            zero_pad)
        packed, s_w = ci.pack_weight(weight)
        xq, amax = ci.quantize_activation(x)
        acc = ci.conv_codes(xq, amax, packed, s_w, None, plan, 512, 'acc')
        wq, _ = quant.quantize_weight(weight)
        ref_acc = quant.conv2d_acc(quant.quantize(x, quant.act_scale(x)), wq,
                                   stride, d, d, 1, mode, zero_pad)
        torch.cuda.synchronize()
        assert torch.equal(acc, ref_acc), (d, stride, mode, zero_pad)
        with torch.no_grad():
            out = ci.quantized_conv2d(x, weight, bias, stride, d, d, 1, mode,
                                      zero_pad=zero_pad)
            ref = quant.quantized_conv2d(x, weight, bias, stride, d, d, 1,
                                         mode, zero_pad=zero_pad)
        torch.cuda.synchronize()
        scale = float(ref.float().abs().max())
        assert float((out.float() - ref.float()).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize('b,c,co,h,w', [(2, 192, 192, 16, 16),
                                        (16, 192, 192, 64, 64),
                                        # split stages, odd sides
                                        (1, 192, 192, 125, 95),
                                        # C % 8 != 0: the bf16 spectrum's
                                        # element loads
                                        (1, 12, 20, 13, 11)])
def test_fourier_unit_store_bf16_kernel(device, b, c, co, h, w):
    """store_bf16 on a bf16 input: the kernel's bf16 output against the
    plain unit rounding at the same four points, within 1e-2 of the
    largest output (one bf16 rounding of a stage may fall the other way
    under another summation order); on an fp32 input the flag does
    nothing: bit-equal to the unit without it."""
    x, args = _fourier_unit_case(device, b, c, co, h, w)
    xb = x.bfloat16()
    ref = fu.fourier_unit_plain(xb, *args, store_bf16=True)
    out = fu.fused_fourier_unit(xb, *args, store_bf16=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 == ref.dtype
    scale = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 1e-2 * scale
    assert not torch.equal(out.float(), fu.fused_fourier_unit(xb, *args))
    assert torch.equal(fu.fused_fourier_unit(x, *args, store_bf16=True),
                       fu.fused_fourier_unit(x, *args))


@pytest.mark.parametrize('kind', ['ffc_resnet', 'pix2pixhd_global',
                                  'pix2pixhd_multidilated'])
def test_int8_generator_kernels_match_plain(device, kind):
    """An int8 generator at the families' widths (ngf 64, 3
    downsamplings), one block, fp32 compute: every eligible conv on the
    int8 kernel (FFC: 4 downsamples, 3 x 2 FFC convs, 2 x 2 1x1 convs, 3
    ConvTranspose = 17; GlobalGenerator: 3 + 2 + 3 = 8; multidilated (cat_in,
    dilations 1-8): 3 + 8 + 3 = 14), the reflect-conv
    kernels 2, 3, 4 and 6 idle, against the int8 plain generator within
    1e-2 (sigmoid output; a code may round the other way where the
    non-int8 kernels' sums differ from the plain ones in the last bit)."""
    from lama_tpu_torch.models import make_generator
    from lama_tpu_torch.ops.kernels import conv_int8 as ci
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    from lama_tpu_torch.ops.serving_mode import ServingMode
    kw = dict(input_nc=4, output_nc=3, ngf=64, n_downsampling=3, n_blocks=1,
              add_out_act='sigmoid', serving_mode=ServingMode(int8=True))
    if kind == 'ffc_resnet':
        kw.update(init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0,
                                        enable_lfu=False),
                  downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0,
                                              enable_lfu=False),
                  resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75,
                                          enable_lfu=False))
    if kind == 'pix2pixhd_multidilated':
        kw['multidilation_kwargs'] = dict(comb_mode='cat_in', dilation_num=4)
    plain = make_generator(kind, kernels='plain', **kw).eval()
    ours = make_generator(kind, **kw).eval()
    ours.load_state_dict(plain.state_dict())
    x = torch.rand(2, 4, 128, 128, generator=torch.Generator().manual_seed(2))
    fns = (ci.quantized_conv2d, rc.reflect_conv3x3_cols,
           rc.reflect_conv3x3_taps, rc.reflect_down_conv3x3,
           hc.halo_conv3x3_reflect, fu.fused_fourier_unit,
           rc.reflect_out_conv7x7, hc.halo_conv_reflect_tiled)
    before = [fn.launches for fn in fns]
    with torch.inference_mode():
        ref = plain.to(device)(x.to(device))
        out = ours.to(device)(x.to(device))
    after = [fn.launches for fn in fns]
    want = {'ffc_resnet': [17, 0, 0, 0, 0, 2, 1, 1],
            'pix2pixhd_global': [8, 0, 0, 0, 0, 0, 1, 1],
            'pix2pixhd_multidilated': [14, 0, 0, 0, 0, 0, 1, 1]}[kind]
    assert [a - b for a, b in zip(after, before)] == want
    assert float((out - ref).abs().max()) <= 1e-2
