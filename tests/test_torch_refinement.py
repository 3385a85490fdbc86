"""The port's refinement slice against lama_tpu on the CPU.

The same numpy inputs go through the JAX function and the port's. Bounds:
- parts (resize, blur, pyramid, erosion, padding, the scale loss): fp32,
  rtol 1e-5 / atol 1e-6 (summation order only);
- the generator's front and rear stages: rtol 1e-3 / atol 2e-4, the bounds
  of tests/test_torch_ffc.py;
- the gradient of one scale's loss w.r.t. the front features z vs
  `jax.grad` through the JAX rear: rtol 1e-3 / atol 1e-5;
- the whole refiner: see test_refine_predict_matches_jax;
- kernel 4's plain version vs the Pallas kernel in interpret mode, and the
  kernels' autograd wrapper vs plain autograd and the JAX `_diff_wrap`
  gradients: rtol 1e-4 / atol 1e-5, as tests/test_torch_kernels.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lama_tpu.evaluation import refinement as jref
from lama_tpu.models.ffc import FFCResNetGenerator as JaxGenerator
from lama_tpu.ops import blur as jblur
from lama_tpu.ops import resize as jresize
from lama_tpu.ops.pallas import reflect_conv as jrc
from lama_tpu_torch.convert import state_dict_from_flax
from lama_tpu_torch.evaluation import refinement as tref
from lama_tpu_torch.models import make_generator
from lama_tpu_torch.ops import blur as tblur
from lama_tpu_torch.ops import resize as tresize
from lama_tpu_torch.ops.kernels import _autograd
from lama_tpu_torch.ops.kernels import fourier_unit as tfu
from lama_tpu_torch.ops.kernels import reflect_conv as trc

torch.set_num_threads(1)

# the tiny config of tests/test_refinement.py
TINY = dict(
    input_nc=4, output_nc=3, ngf=8, n_downsampling=2, n_blocks=2,
    add_out_act='sigmoid',
    init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75, enable_lfu=False),
)
PARTS = dict(rtol=1e-5, atol=1e-6)
GEN = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


@pytest.fixture(scope='module')
def models():
    gen = JaxGenerator(**TINY)
    variables = gen.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4)),
                         train=False)
    rng = np.random.RandomState(5)   # non-trivial BN statistics
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.rand(*v.shape).astype(np.float32) * 0.2,
        variables['batch_stats'])
    variables = {'params': variables['params'], 'batch_stats': stats}
    port = make_generator('ffc_resnet', **TINY)
    port.load_state_dict(state_dict_from_flax(variables, 2, 2), strict=True)
    return gen, variables, port.eval()


# ------------------------------------------------------------------ parts

@pytest.mark.parametrize('size', [(13, 29), (40, 24), (7, 7)])
def test_interpolate_matches_jax(size):
    x = np.random.RandomState(0).rand(2, 20, 30, 3).astype(np.float32)
    for mode in ('bilinear', 'nearest'):
        ref = jresize.interpolate(jnp.asarray(x), size=size, mode=mode)
        out = tresize.interpolate(_nchw(x), size=size, mode=mode)
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **PARTS)


def test_gaussian_blur_matches_jax():
    x = np.random.RandomState(1).rand(1, 17, 23, 3).astype(np.float32)
    for ks, sigma in ((5, 1.0), ((3, 7), (0.5, 2.0))):
        ref = jblur.gaussian_blur2d(jnp.asarray(x), ks, sigma)
        out = tblur.gaussian_blur2d(_nchw(x), ks, sigma)
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **PARTS)


def test_pyrdown_matches_jax():
    rng = np.random.RandomState(2)
    im = rng.rand(1, 34, 50, 3).astype(np.float32)
    m = (rng.rand(1, 34, 50, 1) > 0.7).astype(np.float32)
    np.testing.assert_allclose(_nhwc(tref._pyrdown(_nchw(im))),
                               np.asarray(jref._pyrdown(jnp.asarray(im))),
                               **PARTS)
    for kw in (dict(), dict(blur_mask=False, round_up=False)):
        out = _nhwc(tref._pyrdown_mask(_nchw(m), **kw))
        ref = np.asarray(jref._pyrdown_mask(jnp.asarray(m), **kw))
        np.testing.assert_array_equal(out, ref)


def test_erode_mask_matches_jax():
    m = np.zeros((1, 40, 44, 1), np.float32)
    m[:, 5:30, 8:40] = 1.0
    m[:, 12:14, 20:22] = 0.0
    for size in (3, 15):
        ek = tref._ellipse_kernel(size)
        np.testing.assert_array_equal(ek, jref._ellipse_kernel(size))
        out = _nhwc(tref._erode_mask(_nchw(m), ek))
        ref = np.asarray(jref._erode_mask(jnp.asarray(m), ek))
        np.testing.assert_array_equal(out, ref)


def test_pad_tensor_to_modulo_matches_jax():
    im = np.random.RandomState(3).rand(1, 50, 70, 3).astype(np.float32)
    out = tref.pad_tensor_to_modulo(_nchw(im), 8)
    assert out.shape == (1, 3, 56, 72)
    np.testing.assert_array_equal(
        _nhwc(out), np.asarray(jref.pad_tensor_to_modulo(jnp.asarray(im), 8)))


@pytest.mark.parametrize('hw,unpad,budget', [((120, 140), None, 100000),
                                             ((128, 136), (120, 130), 64 * 64)])
def test_pyramid_matches_jax(hw, unpad, budget):
    rng = np.random.RandomState(4)
    im = rng.rand(1, *hw, 3).astype(np.float32)
    m = (rng.rand(1, *hw, 1) > 0.6).astype(np.float32)
    ims, ms = tref._get_image_mask_pyramid(_nchw(im), _nchw(m), unpad, 30, 3,
                                           budget)
    jims, jms = jref._get_image_mask_pyramid(jnp.asarray(im), jnp.asarray(m),
                                             unpad, 30, 3, budget)
    assert len(ims) == len(jims) > 1
    for a, b in zip(ims + ms, jims + jms):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), **PARTS)


def test_scale_loss_matches_jax():
    rng = np.random.RandomState(6)
    pred = rng.rand(1, 40, 48, 3).astype(np.float32)
    image = rng.rand(1, 40, 48, 3).astype(np.float32)
    mask = np.zeros((1, 40, 48, 1), np.float32)
    mask[:, 8:30, 10:40] = 1.0
    mask3 = np.repeat(mask, 3, axis=-1)
    ref = rng.rand(1, 18, 22, 3).astype(np.float32)
    ek = tref._ellipse_kernel(5)
    ours = tref._scale_loss(_nchw(pred), _nchw(image), _nchw(mask3),
                            _nchw(ref), (37, 45), ek)
    theirs = jref._scale_loss(jnp.asarray(pred), jnp.asarray(image),
                              jnp.asarray(mask3), jnp.asarray(ref), (37, 45), ek)
    np.testing.assert_allclose(float(ours), float(theirs), **PARTS)


# ------------------------------------------------------------------ stages

def _input(seed, h=32, w=40):
    rng = np.random.RandomState(seed)
    image = rng.rand(1, h, w, 3).astype(np.float32)
    mask = np.zeros((1, h, w, 1), np.float32)
    mask[:, h // 4:3 * h // 4, w // 4:w // 2] = 1.0
    return image, mask, np.concatenate([image * (1 - mask), mask], -1)


def test_front_rear_split_equals_full(models):
    _, _, port = models
    x = _nchw(_input(7)[2])
    with torch.no_grad():
        full = port(x)
        z = port(x, stage='front')
        assert isinstance(z, tuple) and all(t is not None for t in z)
        split = port(z, stage='rear')
    torch.testing.assert_close(split, full, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        port(x, stage='middle')


def test_front_and_rear_match_jax(models):
    gen, variables, port = models
    x = _input(8)[2]
    jz = gen.apply(variables, jnp.asarray(x), train=False, stage='front')
    with torch.no_grad():
        z = port(_nchw(x), stage='front')
    for a, b in zip(z, jz):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), **GEN)
    # the rear on the same (JAX) features
    jout = gen.apply(variables, jz, train=False, stage='rear')
    with torch.no_grad():
        out = port(tuple(_nchw(np.asarray(t)) for t in jz), stage='rear')
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), **GEN)


def test_scale_loss_gradient_matches_jax(models):
    gen, variables, port = models
    image, mask, x = _input(9)
    ref = np.random.RandomState(10).rand(1, 16, 20, 3).astype(np.float32)
    mask3 = np.repeat(mask, 3, axis=-1)
    ek = tref._ellipse_kernel(5)

    jz = gen.apply(variables, jnp.asarray(x), train=False, stage='front')

    def jloss(z):
        pred = gen.apply(variables, z, train=False, stage='rear')
        return jref._scale_loss(pred.astype(jnp.float32), jnp.asarray(image),
                                jnp.asarray(mask3), jnp.asarray(ref), (32, 40),
                                ek)

    jgrad = jax.grad(jloss)(jz)
    z = [_nchw(np.asarray(t)).requires_grad_() for t in jz]
    loss = tref._scale_loss(port(tuple(z), stage='rear'), _nchw(image),
                            _nchw(mask3), _nchw(ref), (32, 40), ek)
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jz)), **GEN)
    grads = torch.autograd.grad(loss, z)
    for a, b in zip(grads, jgrad):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)


def test_refine_predict_matches_jax(models):
    """Both refiners on the same inputs, 2 scales, n_iters 3 (2 Adam steps),
    atol 1e-4 on a [0, 1] image. Adam's first steps are sign-like (m /
    sqrt(v) is +-1 at step 1 for any gradient element above eps), so the
    two frameworks' rounding differences in the gradient do not shrink with
    its size: a near-zero element may step by lr one way in one and the
    other way in the other, and differences grow with the steps. Measured on
    this input: 6e-8 after 2 steps, 1.1e-5 after 14 (n_iters 15); the bound
    is ten times the latter. Known pixels are the input's in both."""
    gen, variables, port = models
    h, w = 120, 140
    rng = np.random.RandomState(11)
    image = rng.rand(1, h, w, 3).astype(np.float32)
    mask = np.zeros((1, h, w, 1), np.float32)
    mask[:, 40:80, 50:100] = 1.0
    kw = dict(modulo=8, n_iters=3, lr=0.002, min_side=60, max_scales=2,
              px_budget=100000)
    ref = np.asarray(jref.refine_predict(image, mask, gen, variables, **kw))
    out, losses = tref.refine_predict(image, mask, port, return_losses=True,
                                      **kw)
    assert out.shape == (1, h, w, 3) == ref.shape
    out = out.numpy()
    known = mask[0, :, :, 0] < 0.5
    np.testing.assert_array_equal(out[0][known], image[0][known])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert [len(v) for v in losses] == [0, 2]
    np.testing.assert_array_equal(
        tref.refine_predict(image, mask, port, **kw).numpy(), out)
    assert all(p.requires_grad for p in port.parameters())   # restored


def test_refine_predict_rejects_unported_options(models):
    """`mesh` (spatial sharding, ROADMAP item 11b) raises; `gpu_ids` is
    ignored, as lama_tpu ignores it: the output equals that of None."""
    _, _, port = models
    image, mask, _ = _input(12)
    with pytest.raises(NotImplementedError, match='item 11b'):
        tref.refine_predict(image, mask, port, mesh=object())
    kw = dict(modulo=8, n_iters=2, min_side=16, max_scales=1)
    out = tref.refine_predict(image, mask, port, **kw)
    np.testing.assert_array_equal(
        tref.refine_predict(image, mask, port, gpu_ids='0,1', **kw).numpy(),
        out.numpy())


# ------------------------------------------------------------ down conv

@pytest.mark.parametrize('h,w,c,co', [(128, 128, 64, 128), (64, 64, 128, 256),
                                      (64, 32, 256, 512)])
def test_down_conv_plain_matches_pallas_interpret(h, w, c, co):
    rng = np.random.RandomState(0)
    x = rng.rand(2, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, co) * 0.05).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    weight = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    for b in (None, bias):
        ref = jrc.reflect_down_conv3x3(
            jnp.asarray(x), jnp.asarray(k),
            bias=None if b is None else jnp.asarray(b), dtype=jnp.float32,
            interpret=True)
        before = trc.reflect_down_conv3x3.launches
        out = trc.reflect_down_conv3x3(
            _nchw(x), weight, None if b is None else torch.from_numpy(b))
        assert trc.reflect_down_conv3x3.launches == before   # CPU: no launch
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize('h,w,c,co', [(512, 512, 64, 128), (1000, 760, 64, 128),
                                      (250, 190, 256, 384), (64, 64, 4, 128),
                                      (63, 64, 128, 256), (6, 8, 128, 128)])
def test_down_conv_envelope(h, w, c, co):
    ours = trc.reflect_down_conv3x3_supported(h, w, c, co)
    # the TPU's envelope without its row tiling (h % min(h, 256)) and VMEM
    # cap, so every shape the TPU kernel takes, and the refiner's 1000 rows
    assert ours == ((2 * c) % 128 == 0 and co % 128 == 0 and h % 2 == 0
                    and w % 2 == 0 and min(h, w) >= 8)
    assert ours or not jrc.reflect_down_conv3x3_supported(h, w, c, co)


# ------------------------------------------------------ backward wrappers

@pytest.mark.parametrize('name,stride,c,co,k', [
    ('reflect_conv3x3_cols', 1, 128, 128, 3),
    ('reflect_conv3x3_taps', 1, 128, 256, 3),
    ('reflect_down_conv3x3', 2, 128, 256, 3),
    ('reflect_out_conv7x7', 1, 16, 3, 7),
])
def test_backward_wrapper_matches_plain_and_jax(name, stride, c, co, k):
    """The kernels' autograd wrapper with its forward pointed at the plain
    version (the CPU has no kernel): gradients of x, weight and bias equal
    plain autograd's and the JAX `_diff_wrap` gradients."""
    rng = np.random.RandomState(1)
    x = rng.rand(2, 16, 16, c).astype(np.float32)
    kern = (rng.randn(k, k, c, co) * 0.05).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)

    def leaves():
        return (_nchw(x).requires_grad_(),
                torch.from_numpy(np.ascontiguousarray(
                    np.transpose(kern, (3, 2, 0, 1)))).requires_grad_(),
                torch.from_numpy(bias).requires_grad_())

    plain = functools.partial(trc.reflect_conv_plain, stride=stride)
    a = leaves()
    ours = torch.autograd.grad(
        torch.tanh(_autograd.differentiable(plain, plain, *a)).sum(), a)
    b = leaves()
    ref = torch.autograd.grad(torch.tanh(plain(*b)).sum(), b)
    for g, r in zip(ours, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)

    jfn = getattr(jrc, name)
    wrap = (jrc._diff_wrap7 if k == 7 else
            functools.partial(jrc._diff_wrap, stride=stride))
    wrapped = wrap(lambda x, kk, bias: jfn(x, kk, bias=bias,
                                           dtype=jnp.float32, interpret=True))
    jg = jax.grad(lambda *v: jnp.sum(jnp.tanh(wrapped(*v))), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias))
    np.testing.assert_allclose(_nhwc(ours[0]), np.asarray(jg[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ours[1].numpy().transpose(2, 3, 1, 0),
                               np.asarray(jg[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(jg[2]), rtol=1e-4,
                               atol=1e-4)


def test_fourier_unit_backward_wrapper_matches_plain():
    rng = np.random.RandomState(2)
    c = co = 8
    x = rng.rand(2, c, 12, 10).astype(np.float32)
    params = [(rng.randn(2 * co, 2 * c, 1, 1) * 0.3).astype(np.float32),
              (rng.rand(2 * co) + 0.5).astype(np.float32),
              rng.randn(2 * co).astype(np.float32)]
    stats = [torch.from_numpy((rng.randn(2 * co) * 0.1).astype(np.float32)),
             torch.from_numpy((rng.rand(2 * co) + 0.5).astype(np.float32))]

    def leaves():
        return [torch.from_numpy(v).requires_grad_() for v in [x] + params]

    a = leaves()
    ours = torch.autograd.grad(torch.tanh(_autograd.differentiable(
        tfu.fourier_unit_plain, tfu.fourier_unit_plain, *a, *stats)).sum(), a)
    b = leaves()
    ref = torch.autograd.grad(
        torch.tanh(tfu.fourier_unit_plain(*b, *stats)).sum(), b)
    for g, r in zip(ours, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)
