"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked `cuda`; every test skips without a card (decided inside the fixture,
never at import). Run on a machine with one:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
(--noconftest: tests/conftest.py sets up JAX, which the card's machine
does not need.)
Bounds: fp32 kernel vs fp32 plain rtol 1e-4 / atol 1e-4 (summation order);
bf16 kernel vs the fp32 plain output rtol 2e-2 / atol 2e-2 (bf16 operands).
chip_smoke.py holds the same kernels at the big-lama shapes.
"""
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
@pytest.mark.parametrize('name,c,co,h,w,k,bias', [
    ('reflect_conv3x3_cols', 128, 128, 16, 24, 3, False),
    ('reflect_conv3x3_cols', 128, 128, 13, 9, 3, True),     # partial tiles
    ('reflect_conv3x3_taps', 384, 128, 16, 16, 3, False),
    ('reflect_conv3x3_taps', 128, 384, 8, 40, 3, True),
    ('reflect_out_conv7x7', 64, 3, 37, 70, 7, True),
    ('reflect_out_conv7x7', 16, 8, 8, 8, 7, False),
])
def test_reflect_conv_kernel(device, dtype, name, c, co, h, w, k, bias):
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, c, h, w, generator=g).to(device)
    wt = ((torch.rand(co, c, k, k, generator=g) * 2 - 1)
          * (c * k * k) ** -0.5).to(device)
    b = torch.rand(co, generator=g).to(device) if bias else None
    ref = rc.reflect_conv_plain(x, wt, b)
    fn = getattr(rc, name)
    before = fn.launches
    out = fn(x.to(dtype), wt, b)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    _close(out, ref, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,c,co,h,w', [(2, 192, 192, 16, 16),
                                        (1, 8, 4, 12, 10)])
def test_fourier_unit_kernel(device, dtype, b, c, co, h, w):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(b, c, h, w, generator=g).to(device)
    args = [((torch.rand(2 * co, 2 * c, 1, 1, generator=g) * 2 - 1) * 0.1),
            1 + 0.2 * torch.rand(2 * co, generator=g),
            0.1 * torch.rand(2 * co, generator=g),
            0.1 * torch.rand(2 * co, generator=g),
            1 + 0.3 * torch.rand(2 * co, generator=g)]
    args = [a.to(device) for a in args]
    ref = fu.fourier_unit_plain(x, *args)
    before = fu.fused_fourier_unit.launches
    out = fu.fused_fourier_unit(x.to(dtype), *args)
    torch.cuda.synchronize()
    assert fu.fused_fourier_unit.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out, ref, dtype)


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
    before = (rc.reflect_conv3x3_cols.launches, rc.reflect_conv3x3_taps.launches,
              fu.fused_fourier_unit.launches, rc.reflect_out_conv7x7.launches)
    with torch.inference_mode():
        ref = plain.to(device)(x.to(device))
        out = ours.to(device)(x.to(device))
    after = (rc.reflect_conv3x3_cols.launches, rc.reflect_conv3x3_taps.launches,
             fu.fused_fourier_unit.launches, rc.reflect_out_conv7x7.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 4, 2, 1]
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
