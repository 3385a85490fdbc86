"""The parts of the port's training path against lama_tpu's, on the CPU.

Each on the same numpy inputs, fp32 (rtol 1e-4 / atol 1e-5 where the two
differ only in summation order; gradients atol 1e-5 x the largest; ResNetPL's gradient as stated there):
BatchNorm in train mode (output, gradients, running statistics), the
N-layer discriminator (score, features, gradients), the adversarial losses
with R1 (and its gradient through the discriminator), feature matching and
masked L1, the ResNet50-dilated encoder and ResNetPL, and the optimizers
(Adam, AdamW and SGD, with the global-norm clip) against optax on identical
gradients. Also: the FourierUnit's folded weights follow an optimizer step
and train mode, and the step options of ROADMAP queue 1 item 10 train.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lama_tpu.losses import adversarial as jadv
from lama_tpu.losses import feature_matching as jfm
from lama_tpu.losses.perceptual import ResNetPL as JaxResNetPL
from lama_tpu.models.aux.resnet import ResNetDilatedEncoder as JaxEncoder
from lama_tpu.models.pix2pixhd import NLayerDiscriminator as JaxDisc
from lama_tpu.ops.norm import BatchNorm as JaxBN
from lama_tpu.training import state as jstate
from lama_tpu_torch.convert import state_dict_from_flax
from lama_tpu_torch.losses import adversarial as tadv
from lama_tpu_torch.losses import feature_matching as tfm
from lama_tpu_torch.losses.perceptual import ResNetPL
from lama_tpu_torch.models import make_discriminator
from lama_tpu_torch.models.aux.resnet import ResNetDilatedEncoder
from lama_tpu_torch.models.ffc import FourierUnit
from lama_tpu_torch.ops.norm import BatchNorm2d
from lama_tpu_torch.training.state import clip_grad_norm, make_optimizer
from lama_tpu_torch.training.step import InpaintingTrainStep

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _close(ours, theirs, rtol=RTOL, atol=ATOL, msg=''):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=rtol,
                               atol=atol, err_msg=msg)


def _grads_close(ours, theirs):
    """Two {name: array} gradient dicts, atol 1e-5 x the largest."""
    assert set(ours) == set(theirs)
    scale = max(float(np.abs(v).max()) for v in theirs.values())
    for k in theirs:
        _close(ours[k], theirs[k], rtol=1e-4, atol=1e-5 * scale, msg=k)


def test_batchnorm_train_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 7, 9, 5) * 2 + 1).astype(np.float32)
    r = rng.randn(3, 7, 9, 5).astype(np.float32)
    bn = JaxBN()
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    params = {'scale': (rng.rand(5) + 0.5).astype(np.float32),
              'bias': rng.randn(5).astype(np.float32)}
    stats = {'mean': rng.randn(5).astype(np.float32) * 0.1,
             'var': (rng.rand(5) + 0.5).astype(np.float32)}

    def f(p, x):
        y, upd = bn.apply({'params': p, 'batch_stats': stats}, x,
                          use_running_average=False, mutable=['batch_stats'])
        return jnp.sum(y * r), (y, upd['batch_stats'])

    (_, (y, new_stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tb = BatchNorm2d(5).train()
    with torch.no_grad():
        for t, a in ((tb.weight, params['scale']), (tb.bias, params['bias']),
                     (tb.running_mean, stats['mean']),
                     (tb.running_var, stats['var'])):
            t.copy_(torch.from_numpy(a))
    xt = _nchw(x).requires_grad_()
    out = tb(xt)
    (out * _nchw(r)).sum().backward()
    _close(_nhwc(out), y)
    _close(_nhwc(xt.grad), gx, atol=1e-4)
    _close(tb.weight.grad, gp['scale'], atol=1e-4)
    _close(tb.bias.grad, gp['bias'], atol=1e-4)
    _close(tb.running_mean, new_stats['mean'])
    _close(tb.running_var, new_stats['var'])
    # bf16 activations: statistics in float32, output in bfloat16
    yb = tb(_nchw(x).to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16
    _close(_nhwc(yb.float()), y, rtol=2e-2, atol=2e-2)


@pytest.fixture(scope='module')
def discriminators():
    rng = np.random.RandomState(1)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    jd = JaxDisc(input_nc=3, ndf=8, n_layers=2)
    v = jax.jit(jd.init, static_argnames='train')(jax.random.PRNGKey(2),
                                                  jnp.asarray(x), train=False)
    td = make_discriminator('pix2pixhd_nlayer', input_nc=3, ndf=8, n_layers=2)
    td.load_state_dict(state_dict_from_flax(v), strict=True)
    return jd, v, td.train(), x


def test_discriminator_matches_jax(discriminators):
    jd, v, td, x = discriminators
    rng = np.random.RandomState(3)

    def f(p, x):
        (score, feats), upd = jd.apply({'params': p, 'batch_stats': v['batch_stats']},
                                       x, train=True, mutable=['batch_stats'])
        return jnp.sum(score * r), (score, feats, upd['batch_stats'])

    score_shape = (2, 19, 19, 1)
    r = rng.randn(*score_shape).astype(np.float32)
    (_, (score, feats, stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v['params'], jnp.asarray(x))
    assert score.shape == score_shape
    xt = _nchw(x).requires_grad_()
    ts, tf = td(xt)
    (ts * _nchw(r)).sum().backward()
    _close(_nhwc(ts), score)
    assert len(tf) == len(feats) == 3
    for a, b in zip(tf, feats):
        _close(_nhwc(a), b)
    _close(_nhwc(xt.grad), gx, atol=1e-4)
    ref = state_dict_from_flax({'params': gp})
    _grads_close({n: p.grad.numpy() for n, p in td.named_parameters()},
                 {k: t.numpy() for k, t in ref.items()})
    for k, t in state_dict_from_flax({'batch_stats': stats}).items():
        if not k.endswith('num_batches_tracked'):
            _close(td.state_dict()[k], t, msg=k)
    assert 'model0.0.weight' in td.state_dict()
    assert 'model1.1.running_mean' in td.state_dict()


ADV_KW = dict(weight=10, gp_coef=0.001, mask_as_fake_target=True,
              allow_scale_mask=True)


def test_adversarial_losses_and_r1_match_jax(discriminators):
    """Generator and discriminator losses (mask nearest-resized to the
    score), the R1 penalty, and the D loss's gradient w.r.t. the
    discriminator's parameters through R1 (a second differentiation)."""
    jd, v, td, x = discriminators
    rng = np.random.RandomState(4)
    fake = rng.rand(2, 64, 64, 3).astype(np.float32)
    mask = np.zeros((2, 64, 64, 1), np.float32)
    mask[:, 10:40, 20:50] = 1
    jloss, tloss = jadv.make_discrim_loss('r1', **ADV_KW), \
        tadv.make_discrim_loss('r1', **ADV_KW)

    def d_loss(p, real, fake):
        def real_fn(im):
            (score, _), _ = jd.apply({'params': p, 'batch_stats': v['batch_stats']},
                                     im, train=True, mutable=['batch_stats'])
            return score
        real_pred, gp = jloss.r1_penalty(real_fn, real)
        fake_pred = real_fn(fake)
        loss, metrics = jloss.discriminator_loss(real_pred, fake_pred, gp,
                                                 jnp.asarray(mask))
        return loss, (metrics, fake_pred)

    (loss, (metrics, fake_pred)), grads = jax.value_and_grad(
        d_loss, has_aux=True)(v['params'], jnp.asarray(x), jnp.asarray(fake))
    real = _nchw(x).requires_grad_()
    real_score, _ = td(real)
    gp = tloss.r1_penalty(real_score, real)
    fake_score, _ = td(_nchw(fake))
    tl, tm = tloss.discriminator_loss(real_score, fake_score, gp, _nchw(mask))
    td.zero_grad()
    tl.backward()
    _close(tl.item(), loss)
    for k in metrics:
        _close(tm[k].item(), metrics[k], msg=k)
    ref = state_dict_from_flax({'params': grads})
    _grads_close({n: p.grad.numpy() for n, p in td.named_parameters()},
                 {k: t.numpy() for k, t in ref.items()})
    g_loss, _ = jloss.generator_loss(fake_pred, jnp.asarray(mask))
    _close(tloss.generator_loss(fake_score.detach(), _nchw(mask))[0].item(),
           g_loss)
    # bce (ROADMAP queue 1 item 10) builds, without R1 (its values:
    # tests/test_torch_train_modules.py)
    bce = tadv.make_discrim_loss('bce', weight=1)
    assert not bce.has_r1 and float(bce.r1_penalty(fake_score, None)) == 0


def test_feature_matching_and_l1_match_jax():
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, s, s, c).astype(np.float32) for s, c in ((33, 8), (17, 16))]
    targets = [f + 0.1 * rng.randn(*f.shape).astype(np.float32) for f in feats]
    mask = (rng.rand(2, 64, 64, 1) > 0.5).astype(np.float32)
    for m in (None, mask):
        ref = jfm.feature_matching_loss([jnp.asarray(f) for f in feats],
                                        [jnp.asarray(t) for t in targets],
                                        mask=None if m is None else jnp.asarray(m))
        ours = tfm.feature_matching_loss([_nchw(f) for f in feats],
                                         [_nchw(t) for t in targets],
                                         mask=None if m is None else _nchw(m))
        _close(ours.item(), ref)
    pred, img = rng.rand(2, 16, 16, 3).astype(np.float32), rng.rand(2, 16, 16, 3).astype(np.float32)
    m = mask[:, :16, :16]
    _close(tfm.masked_l1_loss(_nchw(pred), _nchw(img), _nchw(m), 10, 0.5).item(),
           jfm.masked_l1_loss(jnp.asarray(pred), jnp.asarray(img), jnp.asarray(m), 10, 0.5))


def test_resnet_pl_matches_jax():
    """The encoder's four stage outputs and ResNetPL (random weights, carried
    over), value and gradient w.r.t. the prediction."""
    rng = np.random.RandomState(6)
    pred = rng.rand(2, 64, 64, 3).astype(np.float32)
    target = rng.rand(2, 64, 64, 3).astype(np.float32)
    enc = JaxEncoder()
    v = jax.jit(enc.init, static_argnames='train')(
        jax.random.PRNGKey(7), jnp.zeros((1, 64, 64, 3)), train=False)
    jpl = JaxResNetPL(variables=v)
    value, gpred = jax.jit(jax.value_and_grad(jpl))(jnp.asarray(pred),
                                                    jnp.asarray(target))
    feats = jax.jit(lambda a: enc.apply(v, a, train=False))(jnp.asarray(pred))
    tpl = ResNetPL(allow_random_weights=True)
    tpl.impl.load_state_dict(state_dict_from_flax(v), strict=True)
    assert 'layer3.0.downsample.0.weight' in tpl.impl.state_dict()
    assert not any(p.requires_grad for p in tpl.parameters())
    tpl.train()
    assert not tpl.impl.training          # frozen: stays in eval mode
    with torch.no_grad():
        tfeats = tpl.impl(_nchw(pred))
    for a, b in zip(tfeats, feats):
        _close(_nhwc(a), b, atol=1e-4)
    pt = _nchw(pred).requires_grad_()
    tv = tpl(pt, _nchw(target))
    tv.backward()
    _close(tv.item(), value)
    # the gradient crosses 53 conv + ReLU layers, where the two forwards'
    # rounding (1e-6) flips a few ReLU gates: held in norm to 1e-3 and
    # elementwise to 5e-3 of the largest
    g, ref = _nhwc(pt.grad), np.asarray(gpred)
    assert np.linalg.norm(g - ref) <= 1e-3 * np.linalg.norm(ref)
    _close(g, ref, rtol=1e-3, atol=5e-3 * float(np.abs(ref).max()))
    with pytest.raises(FileNotFoundError, match='allow_random_weights'):
        ResNetPL(weights_path='/nonexistent/encoder.pth')


@pytest.mark.parametrize('opt', [dict(kind='adam', lr=1e-3),
                                 dict(kind='adamw', lr=1e-3, weight_decay=0.01),
                                 dict(kind='sgd', lr=1e-2)])
def test_optimizers_and_clip_match_optax(opt):
    """Three steps of the port's optimizer after `clip_grad_norm(., 1)`
    against optax's chain (clip_by_global_norm, then the same optimizer) on
    identical gradients; the first step's gradient norm is above the clip,
    the others below."""
    rng = np.random.RandomState(8)
    params = {'a': rng.randn(4, 3).astype(np.float32), 'b': rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*p.shape) * s).astype(np.float32)
              for k, p in params.items()} for s in (3.0, 0.1, 0.05)]
    tx = jstate.make_optimizer(clip_grad_norm=1.0, **opt)
    jp, st = dict(params), tx.init(params)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = make_optimizer(list(tp.values()), **opt)
    for g in grads:
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        clip_grad_norm(list(tp.values()), 1.0)
        topt.step()
    for k in params:
        _close(tp[k].detach(), jp[k], rtol=1e-5, atol=1e-6, msg=k)


def test_fourier_unit_folded_weights_follow_training():
    """The kernel path's folded weights (`planar`) are recomputed after an
    optimizer step (parameters updated in place) and after a train-mode
    forward (BN statistics moved inside PyTorch's batch norm, which bumps no
    version counter), so a unit served after training never uses stale
    folds."""
    from lama_tpu_torch.ops.kernels.fourier_unit import planar_params
    torch.manual_seed(0)
    fu = FourierUnit(4, 4).eval()
    stale = [t.clone() for t in fu.planar()]

    def fresh():
        return planar_params(*fu._params(), eps=fu.bn.eps)

    fu.train()
    opt = torch.optim.Adam(fu.parameters(), lr=1e-2)
    fu(torch.rand(2, 4, 8, 8)).square().sum().backward()
    opt.step()
    fu.eval()
    for a, b, old in zip(fu.planar(), fresh(), stale):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, old)
    # an optimizer step while in eval mode
    kept = [t.clone() for t in fu.planar()]
    fu(torch.rand(2, 4, 8, 8)).sum().backward()
    opt.step()
    for a, b, old in zip(fu.planar(), fresh(), kept):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, old)


@pytest.mark.parametrize('kwargs', [dict(vgg_perceptual=True),
                                    dict(distance_weighter='blur'),
                                    dict(fake_fakes_proba=1.0),
                                    dict(add_noise_kwargs=dict(scales=2)),
                                    dict(r1_every=4)])
def test_step_options_of_later_items_raise(kwargs):
    """The step options ROADMAP queue 1 item 10 ported (the VGG19
    perceptual loss, a distance weighter, fake fakes, input noise, lazy R1)
    train a tiny GlobalGenerator and discriminator one step with finite
    losses and the option's own mark (their values against lama_tpu's:
    tests/test_torch_train_opts_*.py)."""
    from lama_tpu_torch.losses.distance_weighting import \
        make_mask_distance_weighter
    from lama_tpu_torch.losses.perceptual import VGG19PerceptualLoss
    from lama_tpu_torch.models import make_generator
    from lama_tpu_torch.models.fake_fakes import FakeFakesGenerator
    from lama_tpu_torch.training.state import TrainState
    from lama_tpu_torch.training.step import LossConfig
    kw, lc = dict(kwargs), LossConfig(resnet_pl_weight=0)
    if kw.pop('vgg_perceptual', False):
        kw['vgg_perceptual_fn'] = VGG19PerceptualLoss()
        lc = LossConfig(resnet_pl_weight=0, perceptual_weight=1.0)
    if 'distance_weighter' in kw:
        kw['distance_weighter'] = make_mask_distance_weighter(
            kw['distance_weighter'])
    if 'fake_fakes_proba' in kw:
        kw['fake_fakes_gen'] = FakeFakesGenerator()
    scales = kw.get('add_noise_kwargs', {}).get('scales', 0)
    torch.manual_seed(0)
    gen = make_generator('pix2pixhd_global', input_nc=4 + scales, ngf=8,
                         n_downsampling=1, n_blocks=1, add_out_act='sigmoid')
    disc = make_discriminator('ffc_nlayer', input_nc=3, ndf=8, n_layers=2)
    state = TrainState(gen, disc, make_optimizer(gen.parameters(), 'adam'),
                       make_optimizer(disc.parameters(), 'adam'))
    step = InpaintingTrainStep(tadv.make_discrim_loss('r1', **ADV_KW),
                               loss_config=lc, **kw)
    img = torch.rand(2, 3, 32, 32)
    mask = (torch.rand(2, 1, 32, 32) > 0.7).float()
    metrics = {k: float(v) for k, v in step(state, img, mask).items()}
    assert state.step == 1
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    if 'vgg_perceptual_fn' in kw:
        assert metrics['gen_pl'] > 0
    if 'fake_fakes_gen' in kw:   # the draw is 1 at probability 1
        assert metrics['discr_adv_fake_fakes'] > 0
    if 'r1_every' in kw:         # step 0: the penalty, times 4
        assert metrics['discr_real_gp'] > 0


def test_clip_grad_norm_leaves_small_gradients():
    p = torch.nn.Parameter(torch.ones(4))
    p.grad = torch.full((4,), 0.1)
    norm = clip_grad_norm([p], 1.0)
    assert abs(float(norm) - 0.2) < 1e-6
    torch.testing.assert_close(p.grad, torch.full((4,), 0.1))
    p.grad = torch.full((4,), 3.0)
    clip_grad_norm([p], 1.0)
    torch.testing.assert_close(p.grad.norm(), torch.tensor(1.0))


def test_encoder_dilation_and_keys():
    enc = ResNetDilatedEncoder()
    outs = enc(torch.rand(1, 3, 64, 64))
    assert [o.shape[1:] for o in outs] == [(256, 16, 16), (512, 8, 8),
                                           (1024, 8, 8), (2048, 8, 8)]
    plain = ResNetDilatedEncoder(dilated=False)(torch.rand(1, 3, 64, 64))
    assert plain[-1].shape[-1] == 2
