"""The modules of the rest of training against lama_tpu's on the CPU, the
same numpy inputs through both (tiny sizes):
- the FFC discriminator (`FFCNLayerDiscriminator`, ndf 8) with converted
  weights, eval and train-mode BN, at ratio 0 and with a global stream
  (ratio 0.5, no LFU): rtol 1e-3 / atol 2e-4 (its R1 D-loss gradient:
  tests/test_torch_train_opts_ffc.py);
- the bce adversarial loss, values and gradients: 1e-6;
- the VGG trunks (VGG19 avg and max pools, `stop_after`, taps; the LPIPS
  VGG16 default), `VGG19PerceptualLoss.partial_losses` with a mask and
  `StylePerceptualLoss`: rtol 1e-4 / atol 1e-5;
- each distance weighter, `ops/geometry.py` (rotate, affine_warp with zero
  and reflection taps, random_affine on the JAX draws): 1e-5;
- the fake fakes and the noise pyramid on the JAX draws
  (tests/torch_train_common.py replicates them): 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_common as ttc
from lama_tpu.losses import distance_weighting as jdw
from lama_tpu.losses.perceptual import VGG19PerceptualLoss as JaxVGG19PL
from lama_tpu.losses.style import StylePerceptualLoss as JaxStyle
from lama_tpu.models import make_discriminator as jax_discriminator
from lama_tpu.models.aux import vgg as jvgg
from lama_tpu.models.fake_fakes import FakeFakesGenerator as JaxFakeFakes
from lama_tpu.ops import geometry as jgeo
from lama_tpu.training import step as jstep
from lama_tpu_torch.convert import state_dict_from_flax
from lama_tpu_torch.losses import adversarial as tadv
from lama_tpu_torch.losses import distance_weighting as tdw
from lama_tpu_torch.losses.perceptual import VGG19PerceptualLoss
from lama_tpu_torch.losses.style import StylePerceptualLoss
from lama_tpu_torch.models import make_discriminator
from lama_tpu_torch.models.aux import vgg as tvgg
from lama_tpu_torch.models.fake_fakes import FakeFakesGenerator
from lama_tpu_torch.ops import geometry as tgeo
from lama_tpu_torch.training import step as tstep

torch.set_num_threads(1)

nchw = ttc.nchw


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _close(ours, theirs, rtol=1e-5, atol=1e-5, msg=''):
    np.testing.assert_allclose(_nhwc(ours) if isinstance(ours, torch.Tensor)
                               and ours.dim() == 4 else np.asarray(ours),
                               np.asarray(theirs), rtol=rtol, atol=atol,
                               err_msg=msg)


# ------------------------------------------------------ FFC discriminator
FFC_D_CASES = {
    'ratio0': dict(input_nc=3, ndf=8, n_layers=3),
    'global': dict(input_nc=3, ndf=8, n_layers=2,
                   init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0.5,
                                         enable_lfu=False),
                   conv_kwargs=dict(ratio_gin=0.5, ratio_gout=0.5,
                                    enable_lfu=False)),
}


def _ffc_d(kw, x):
    jd = jax_discriminator('ffc_nlayer', **kw)
    # non-trivial running statistics, so eval-mode BN is exercised
    v = ttc.jax_variables(jd, jnp.asarray(x), train=False)
    td = make_discriminator('ffc_nlayer', **kw)
    td.load_state_dict(state_dict_from_flax(v), strict=True)
    return jd, v, td


@pytest.mark.parametrize('case', sorted(FFC_D_CASES))
@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_ffc_discriminator_matches_jax(case, train):
    kw = FFC_D_CASES[case]
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    jd, v, td = _ffc_d(kw, x)
    if train:
        (score, feats), upd = jax.jit(functools.partial(
            jd.apply, train=True, mutable=['batch_stats']))(v, jnp.asarray(x))
    else:
        score, feats = jax.jit(functools.partial(jd.apply, train=False))(
            v, jnp.asarray(x))
    td.train(train)
    with torch.no_grad():
        tscore, tfeats = td(nchw(x))
    assert len(tfeats) == len(feats) == kw['n_layers'] + 1
    _close(tscore, score, 1e-3, 2e-4, 'score')
    for i, (a, b) in enumerate(zip(tfeats, feats)):
        _close(a, b, 1e-3, 2e-4, f'feature {i}')
    if train:
        ref = state_dict_from_flax({'batch_stats': upd['batch_stats']})
        for k, t in td.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                _close(t.numpy(), ref[k].numpy(), 1e-4, 1e-5, k)


def test_ffc_discriminator_keys_are_the_references():
    td = make_discriminator('ffc_nlayer', input_nc=3, ndf=8, n_layers=2)
    keys = set(td.state_dict())
    assert {'model0.0.ffc.convl2l.weight', 'model0.0.bn_l.running_mean',
            'model1.0.ffc.convl2l.weight', 'model2.0.bn_l.weight',
            'model3.0.weight', 'model3.0.bias'} <= keys
    assert not any('bn_g' in k or 'convg2g' in k for k in keys)


# ------------------------------------------------------------------ bce
def test_bce_loss_matches_jax():
    rng = np.random.RandomState(3)
    real = rng.randn(2, 9, 9, 1).astype(np.float32)
    fake = rng.randn(2, 9, 9, 1).astype(np.float32)
    mask = (rng.rand(2, 36, 36, 1) > 0.5).astype(np.float32)
    jl = ttc._jax_adversarial('bce')
    tl = ttc._port_adversarial('bce')
    assert not tl.has_r1
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda r, f: jl.discriminator_loss(r, f, 0.0, jnp.asarray(mask)),
        argnums=(0, 1), has_aux=True)(jnp.asarray(real), jnp.asarray(fake))
    tr, tf = nchw(real).requires_grad_(), nchw(fake).requires_grad_()
    tloss, tm = tl.discriminator_loss(tr, tf, tl.r1_penalty(tr, tr), nchw(mask))
    tloss.backward()
    _close(float(tloss), jloss, 1e-6, 1e-6)
    _close(tr.grad, jgrads[0], 1e-6, 1e-6)
    _close(tf.grad, jgrads[1], 1e-6, 1e-6)
    for k in jm:
        _close(float(tm[k]), jm[k], 1e-6, 1e-6, k)
    jg, _ = jl.generator_loss(jnp.asarray(fake))
    _close(float(tl.generator_loss(nchw(fake))[0]), jg, 1e-6, 1e-6)
    with pytest.raises(TypeError):   # as lama_tpu's: no R1 options
        tadv.make_discrim_loss('bce', weight=1, gp_coef=0.001)


# ------------------------------------------------------------------ VGG
VGG_CASES = {
    'vgg19_avg_stop30': dict(cfg=tuple(jvgg.VGG19_CFG), pool='avg',
                             stop_after=30, taps=(1, 3, 6, 13, 29)),
    'vgg19_max_relu_n_1': dict(cfg=tuple(jvgg.VGG19_CFG), pool='max',
                               stop_after=None, taps=(1, 6, 11, 20, 29)),
    'vgg19_pps_level2': dict(cfg=tuple(jvgg.VGG19_CFG), pool='avg',
                             stop_after=4, taps=(3,)),
    'vgg16_lpips': dict(cfg=tuple(jvgg.VGG16_CFG), pool='max',
                        stop_after=None, taps=jvgg.VGG16_LPIPS_TAPS),
}


@pytest.mark.parametrize('case', sorted(VGG_CASES))
def test_vgg_features_match_jax(case):
    c = VGG_CASES[case]
    x = np.random.RandomState(4).randn(1, 32, 32, 3).astype(np.float32)
    jm = jvgg.VGGFeatures(cfg=c['cfg'], tap_indices=c['taps'], pool=c['pool'],
                          stop_after=c['stop_after'])
    v = ttc.jax_variables(jm, jnp.asarray(x))
    theirs = jax.jit(jm.apply)(v, jnp.asarray(x))
    if case == 'vgg16_lpips':
        tm = tvgg.VGGFeatures()   # LPIPS's trunk keeps its default
    else:
        tm = tvgg.VGGFeatures(list(c['cfg']), c['taps'], c['pool'],
                              c['stop_after'])
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        ours = tm(nchw(x))
    assert len(ours) == len(theirs) == len(c['taps'])
    for i, (a, b) in enumerate(zip(ours, theirs)):
        scale = float(np.abs(np.asarray(b)).max())
        _close(a, b, 1e-4, 1e-5 * max(scale, 1.0), f'tap {i}')


def test_vgg_taps_match_jax():
    from lama_tpu.losses.perceptual import _vgg19_relu_taps
    from lama_tpu.losses.style import _relu_n_1_taps
    assert tvgg.relu_taps(tvgg.VGG19_CFG, 30) == _vgg19_relu_taps(30)
    assert tvgg.relu_taps(tvgg.VGG19_CFG, first_in_stage=True) == \
        _relu_n_1_taps()


def test_vgg19_perceptual_and_style_losses_match_jax():
    rng = np.random.RandomState(5)
    a, b = (rng.rand(2, 32, 32, 3).astype(np.float32) for _ in range(2))
    mask = (rng.rand(2, 32, 32, 1) > 0.6).astype(np.float32)
    jpl = JaxVGG19PL(variables=ttc.jax_vgg19_variables(30))
    tpl = VGG19PerceptualLoss()
    tpl.model.load_state_dict(state_dict_from_flax(jpl.variables), strict=True)
    partial = jax.jit(jpl.partial_losses)
    for m in (None, mask):
        theirs = partial(jnp.asarray(a), jnp.asarray(b),
                         None if m is None else jnp.asarray(m))
        with torch.no_grad():
            ours = tpl.partial_losses(nchw(a), nchw(b),
                                      None if m is None else nchw(m))
        assert len(ours) == len(theirs) == 13
        for i, (x, y) in enumerate(zip(ours, theirs)):
            _close(x.numpy(), y, 1e-4, 1e-7, f'tap {i}')
    _close(tpl(nchw(a), nchw(b), nchw(mask)).detach().numpy(),
           np.sum(np.stack(theirs), 0), 1e-4, 1e-7)
    jst = JaxStyle(variables=ttc.jax_vgg19_variables())
    tst = StylePerceptualLoss()
    tst.model.load_state_dict(state_dict_from_flax(jst.variables), strict=True)
    _close(float(tst(nchw(a), nchw(b))),
           jax.jit(jst.__call__)(jnp.asarray(a), jnp.asarray(b)), 1e-4, 1e-7)


# ------------------------------------------------------ distance weighting
@pytest.mark.parametrize('kind,kwargs', [
    ('none', {}), ('blur', dict(kernel_size=5)),
    ('blur', dict(kernel_size=7, width_factor=2)), ('edt', {}),
    ('pps', dict(max_iters=10)), ('pps', dict(erode_mask_size=0, max_iters=3))])
def test_distance_weighters_match_jax(kind, kwargs):
    rng = np.random.RandomState(6)
    img = rng.rand(2, 32, 40, 3).astype(np.float32)
    pred = rng.rand(2, 32, 40, 3).astype(np.float32)
    mask = np.zeros((2, 32, 40, 1), np.float32)
    mask[0, 5:20, 8:30] = 1
    mask[1, 10:31, 2:14] = 1
    tw = tdw.make_mask_distance_weighter(kind, **kwargs)
    if kind == 'pps':
        jw = jdw.make_mask_distance_weighter(
            kind, vgg_variables=ttc.jax_vgg19_variables(4), **kwargs)
        tw.model.load_state_dict(state_dict_from_flax(jw.variables),
                                 strict=True)
    else:
        jw = jdw.make_mask_distance_weighter(kind, **kwargs)
    theirs = jax.jit(jw)(jnp.asarray(img), jnp.asarray(pred),
                         jnp.asarray(mask))
    ours = tw(nchw(img), nchw(pred), nchw(mask))
    assert not ours.requires_grad
    _close(ours, theirs)
    if kind != 'none':
        assert 0 < float(ours.sum()) < float(mask.sum())


def test_gauss_kernel_is_the_references():
    np.testing.assert_array_equal(tdw.get_gauss_kernel(5, 2),
                                  jdw.get_gauss_kernel(5, 2))


# ------------------------------------------------------------- geometry
@pytest.mark.parametrize('angle', [0.0, 17.5, -90.0, 200.0])
def test_rotate_matches_jax(angle):
    x = np.random.RandomState(7).rand(2, 23, 31, 3).astype(np.float32)
    _close(tgeo.rotate(nchw(x), angle), jgeo.rotate(jnp.asarray(x), angle))


@pytest.mark.parametrize('padding_mode', ['zeros', 'reflection'])
def test_affine_warp_matches_jax(padding_mode):
    x = np.random.RandomState(8).rand(1, 20, 27, 2).astype(np.float32)
    m = np.array([[0.9, -0.3, 4.2], [0.25, 1.1, -7.5]], np.float32)
    _close(tgeo.affine_warp(nchw(x), m, padding_mode=padding_mode),
           jgeo.affine_warp(jnp.asarray(x), jnp.asarray(m),
                            padding_mode=padding_mode))


def test_random_affine_matches_jax_on_its_draws():
    x = np.random.RandomState(9).rand(3, 24, 32, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    theirs = jgeo.random_affine(key, jnp.asarray(x), degrees=30.0,
                                translate=0.2)
    draws = ttc.jax_affine(key, 3, 24, 32, 30.0, 0.2)
    _close(tgeo.random_affine(nchw(x), *draws), theirs)
    # the port's own draws: angles and shifts inside their ranges
    angles, tx, ty = tgeo.draw_random_affine(torch.Generator().manual_seed(0),
                                             64, 24, 32, 30.0, 0.2)
    assert float(angles.abs().max()) <= 30 and float(tx.abs().max()) <= 6.4
    assert float(ty.abs().max()) <= 4.8 and float(angles.std()) > 5


# ------------------------------------------------- fake fakes and noise
def test_fake_fakes_match_jax_on_its_draws():
    rng = np.random.RandomState(12)
    img = rng.rand(4, 32, 32, 3).astype(np.float32)
    mask = np.zeros((4, 32, 32, 1), np.float32)
    for i in range(4):
        mask[i, 4 + i:20 + i, 6:26 - i] = 1
    jgen = JaxFakeFakes()
    key = jax.random.PRNGKey(5)
    theirs, tmask = jax.jit(jgen.__call__)(key, jnp.asarray(img),
                                           jnp.asarray(mask))
    draws = ttc.jax_fake_fakes_draws(key, jgen, 4, 32, 32)
    assert 0 < float(draws.is_aug.sum()) < 4   # both targets met
    ours, omask = FakeFakesGenerator()(draws, nchw(img), nchw(mask))
    _close(omask, tmask)
    _close(ours, theirs)
    # the port's own draws have the same shapes and kinds
    own = FakeFakesGenerator().draw(torch.Generator().manual_seed(0), 4, 32, 32)
    assert sorted(own.perm.tolist()) == [0, 1, 2, 3]
    assert own.is_aug.shape == (4,) and own.mask_affine[0].shape == (4,)


@pytest.mark.parametrize('scales', [1, 3])
def test_multiscale_noise_matches_jax_on_its_draws(scales):
    key = jax.random.PRNGKey(3)
    base = jnp.zeros((2, 40, 24, 3))
    theirs = jstep.make_multiscale_noise(key, base, scales=scales)
    samples = ttc.jax_noise(key, 2, 40, 24, scales, jnp.float32)
    assert [tuple(s.shape) for s in samples] == [
        (2, 1, 40 >> i, 24 >> i) for i in range(scales)]
    _close(tstep.multiscale_noise(samples, (40, 24)), theirs)
    own = tstep.draw_multiscale_noise(torch.Generator().manual_seed(0), 2,
                                      40, 24, scales)
    assert [s.shape for s in own] == [s.shape for s in samples]
