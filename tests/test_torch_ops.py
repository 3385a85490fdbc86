"""The port's ops (lama_tpu_torch.ops) against lama_tpu.ops on the CPU.

Same numpy inputs through both; NHWC on the JAX side, NCHW on the torch
side. fp32, rtol 1e-4 / atol 1e-5 (summation order differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lama_tpu.ops import conv as jconv
from lama_tpu.ops import norm as jnorm
from lama_tpu.ops import pad as jpad
from lama_tpu.ops import spectral as jspec
from lama_tpu_torch.ops import activations, conv, norm, pad, spectral

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize('p', [1, 3])
@pytest.mark.parametrize('mode', ['reflect', 'replicate', 'zeros'])
def test_pad2d(p, mode):
    x = np.random.RandomState(0).rand(2, 9, 11, 3).astype(np.float32)
    ref = jpad.pad2d(jnp.asarray(x), p, mode=mode)
    np.testing.assert_array_equal(_nhwc(pad.pad2d(_nchw(x), p, mode=mode)),
                                  np.asarray(ref))


@pytest.mark.parametrize('k,stride', [(3, 1), (3, 2), (7, 1), (7, 2)])
def test_conv2d_reflect(k, stride):
    rng = np.random.RandomState(k + stride)
    x = rng.rand(2, 16, 20, 8).astype(np.float32)
    kern = (rng.randn(k, k, 8, 6) * 0.1).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias),
                       stride=stride, padding=k // 2, padding_mode='reflect')
    m = conv.Conv2d(8, 6, k, stride=stride, padding=k // 2,
                    padding_mode='reflect')
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.transpose(kern, (3, 2, 0, 1))))
        m.bias.copy_(torch.from_numpy(bias))
        out = m(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_conv_transpose2d():
    rng = np.random.RandomState(3)
    x = rng.rand(2, 8, 10, 6).astype(np.float32)
    kern = (rng.randn(3, 3, 6, 4) * 0.1).astype(np.float32)   # HWIO, I = in
    bias = rng.randn(4).astype(np.float32)
    ref = jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(kern),
                                 jnp.asarray(bias), stride=2, padding=1,
                                 output_padding=1)
    m = conv.ConvTranspose2d(6, 4, 3, stride=2, padding=1, output_padding=1)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.transpose(kern, (2, 3, 0, 1))))
        m.bias.copy_(torch.from_numpy(bias))
        out = m(_nchw(x))
    assert out.shape == (2, 4, 16, 20)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_batchnorm_eval(dtype):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 6, 7).astype(np.float32)
    scale = (rng.rand(7) + 0.5).astype(np.float32)
    bias = rng.randn(7).astype(np.float32)
    mean = rng.randn(7).astype(np.float32)
    var = (rng.rand(7) + 0.5).astype(np.float32)
    ref = jnorm.BatchNorm().apply(
        {'params': {'scale': scale, 'bias': bias},
         'batch_stats': {'mean': mean, 'var': var}},
        jnp.asarray(x), use_running_average=True)
    bn = norm.BatchNorm2d(7).eval()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
        out = bn(_nchw(x).to(dtype))
    assert out.dtype == dtype
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)   # the bf16 input and output roundings
    np.testing.assert_allclose(_nhwc(out.float()), np.asarray(ref), **tol)
    # train mode (held to the JAX function in tests/test_torch_train_parts.py)
    # normalises with the batch's statistics, not these
    with torch.no_grad():
        y = bn.train()(_nchw(x)).float()
    assert float((y - out.float()).abs().max()) > 0.1
    np.testing.assert_allclose(y.mean(dim=(0, 2, 3)).numpy(), bias, atol=1e-5)


@pytest.mark.parametrize('h,w', [(8, 8), (12, 10), (7, 9)])
def test_rfft2_irfft2(h, w):
    x = np.random.RandomState(h * w).rand(2, h, w, 3).astype(np.float32)
    ref_re, ref_im = jspec.rfft2_dft(jnp.asarray(x), dtype=jnp.float32)
    re, im = spectral.rfft2(_nchw(x))
    np.testing.assert_allclose(_nhwc(re), np.asarray(ref_re), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_nhwc(im), np.asarray(ref_im), rtol=RTOL,
                               atol=ATOL)
    back = jspec.irfft2_dft(ref_re, ref_im, s=(h, w), dtype=jnp.float32)
    out = spectral.irfft2(re, im, s=(h, w))
    np.testing.assert_allclose(_nhwc(out), np.asarray(back), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_nhwc(out), x, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('h,w', [(8, 8), (7, 9), (16, 12)])
def test_irfft2_of_a_non_hermitian_spectrum_matches_jax(h, w):
    """A FourierUnit's spectrum (after its 1x1 conv and ReLU) is not
    Hermitian: the DC and Nyquist columns' imaginary parts are dropped after
    the inverse DFT along H, as the JAX package's DFT matmuls drop them."""
    rng = np.random.RandomState(h + w)
    re, im = (rng.randn(2, h, w // 2 + 1, 3).astype(np.float32)
              for _ in range(2))
    ref = jspec.irfft2_dft(jnp.asarray(re), jnp.asarray(im), s=(h, w),
                           dtype=jnp.float32)
    out = spectral.irfft2(_nchw(re), _nchw(im), s=(h, w))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('kind', ['tanh', 'sigmoid', 'relu', 'leaky_relu',
                                  'identity'])
def test_activations(kind):
    from lama_tpu.ops.activations import get_activation
    x = np.linspace(-3, 3, 13).astype(np.float32)
    np.testing.assert_allclose(
        activations.get_activation(kind)(torch.from_numpy(x)).numpy(),
        np.asarray(get_activation(kind)(jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)


def test_conv_kernel_dispatch_on_cpu_is_plain():
    """A kernel-envelope conv on a CPU tensor takes the plain version and
    launches nothing; kernels='plain' gives the same numbers."""
    from lama_tpu_torch.ops.kernels import reflect_conv as rc
    x = torch.rand(1, 128, 8, 8)
    a = conv.Conv2d(128, 128, 3, padding=1, padding_mode='reflect',
                    bias=False)
    b = conv.Conv2d(128, 128, 3, padding=1, padding_mode='reflect',
                    bias=False, kernels='plain')
    b.load_state_dict(a.state_dict())
    before = rc.reflect_conv3x3_cols.launches
    with torch.no_grad():
        torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
    assert rc.reflect_conv3x3_cols.launches == before
    with pytest.raises(ValueError):
        conv.Conv2d(4, 4, 3, kernels='triton')
