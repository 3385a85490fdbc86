"""The port's train step with lama_tpu's training options against lama_tpu's
step on the CPU, the shared harness of tests/test_torch_train_opts_*.py.

A tiny setup: the GlobalGenerator (ngf 8, 2 downsamplings, 1 block,
sigmoid; its input widened by the noise channels), a discriminator of ndf
8 and 2 layers, the big-lama losses without ResNetPL (L1 10, feature
matching 100, the adversarial loss at weight 10), the clip at 1, batch 2 at
32^2. Each group switches on some of lama_tpu's options (the FFC
discriminator, bce, lazy R1, the VGG19 perceptual loss, a distance
weighter, fake fakes, input noise). The JAX variables (the generator, the
discriminator and the VGG19 trunks of the perceptual loss and of pps;
`jax_variables`) are carried into the port with `state_dict_from_flax`, and every random draw
of the JAX step (the noise of `make_multiscale_noise`, the fake-fakes
Bernoulli draw, permutation, warps and augmentation flags) is replicated
here from the step's key, `jax.random.PRNGKey(i)` as lama_tpu's trainer
gives it, and handed to the port's step as its `StepDraws`.

- fp32, SGD: every per-step metric within rtol 1e-3 / atol 1e-5, and the
  BN running statistics after step 1 within 1e-5;
- float64, Adam: the metrics, and the first step's G gradient and the
  gradient of its D objective on the JAX step's D input (after the clip)
  within rtol 1e-3 and atol 1e-5 x the largest (why float64:
  tests/test_torch_train.py). There lama_tpu's BatchNorm computes in
  float64 (`float64_batchnorm`), and its distance weighters, which cannot
  run in float64 (their float32 filter kernels meet a float64 input in
  `lax.conv_general_dilated`), run on float32 copies.
One JAX program per group and precision (the step, and in float64 its
first gradients).
"""
import contextlib
import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from lama_tpu.losses import adversarial as jadv
from lama_tpu.losses.distance_weighting import \
    make_mask_distance_weighter as jax_weighter
from lama_tpu.losses.perceptual import VGG19PerceptualLoss as JaxVGG19PL
from lama_tpu.models.aux.vgg import VGG19_CFG
from lama_tpu.models.aux.vgg import VGGFeatures as JaxVGGFeatures
from lama_tpu.models import make_discriminator as jax_discriminator
from lama_tpu.models import make_generator as jax_generator
from lama_tpu.models.fake_fakes import FakeFakesGenerator as JaxFakeFakes
from lama_tpu.training import state as jstate
from lama_tpu.ops import norm as jnorm
from lama_tpu.training import step as jstep
from lama_tpu_torch.convert import state_dict_from_flax
from lama_tpu_torch.losses.adversarial import make_discrim_loss
from lama_tpu_torch.losses.distance_weighting import make_mask_distance_weighter
from lama_tpu_torch.losses.perceptual import VGG19PerceptualLoss
from lama_tpu_torch.models import make_discriminator, make_generator
from lama_tpu_torch.models.fake_fakes import FakeFakesDraws, FakeFakesGenerator
from lama_tpu_torch.training.state import (TrainState, clip_grad_norm,
                                           make_optimizer)
from lama_tpu_torch.training.step import (EMAConfig, InpaintingTrainStep,
                                          LossConfig, StepDraws)

B, S = 2, 32
GEN_KW = dict(output_nc=3, ngf=8, n_downsampling=2, n_blocks=1,
              add_out_act='sigmoid')
DISC_KW = dict(input_nc=3, ndf=8, n_layers=2)
R1_KW = dict(weight=10, gp_coef=0.001, mask_as_fake_target=True,
             allow_scale_mask=True)   # configs/training/big-lama.yaml
SGD = (dict(kind='sgd', lr=1e-2), dict(kind='sgd', lr=1e-3))
ADAM = (dict(kind='adam', lr=1e-3), dict(kind='adam', lr=1e-4))
CLIP = 1.0
RTOL, ATOL = 1e-3, 1e-5
FAST = dict(compiler_options={'xla_backend_optimization_level': 0,
                              'xla_llvm_disable_expensive_passes': True})


def nchw(a, dtype=None):
    t = torch.from_numpy(np.array(np.transpose(np.asarray(a), (0, 3, 1, 2))))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------ the JAX draws
def _torch(a):
    return torch.from_numpy(np.array(a))


def _affine(key, b, h, w, degrees, translate):
    """lama_tpu/ops/geometry.py:77-80's draws: (angles in degrees, tx, ty
    in pixels)."""
    k1, k2, k3 = jax.random.split(key, 3)
    angles = jax.random.uniform(k1, (b,), minval=-degrees, maxval=degrees)
    tx = jax.random.uniform(k2, (b,), minval=-translate, maxval=translate) * w
    ty = jax.random.uniform(k3, (b,), minval=-translate, maxval=translate) * h
    return angles, tx, ty


def jax_affine(key, b, h, w, degrees, translate):
    return tuple(_torch(a) for a in _affine(key, b, h, w, degrees, translate))


def _fake_fakes_arrays(key, b, h, w, degree, translate, aug_proba):
    """lama_tpu/models/fake_fakes.py:23-39's draws from `key`."""
    k1, k2 = jax.random.split(key)
    ka, kb, kc = jax.random.split(k2, 3)
    return dict(
        mask_affine=_affine(k1, b, 2 * h, 2 * w, 360.0, 0.2),
        perm=jax.random.permutation(ka, b),
        img_affine=_affine(kb, b, h, w, degree, translate),
        is_aug=(jax.random.uniform(kc, (b, 1, 1, 1)) < aug_proba
                ).astype(jnp.float32).reshape(b))


def _fake_fakes_draws(a) -> FakeFakesDraws:
    return FakeFakesDraws(
        mask_affine=tuple(_torch(x) for x in a['mask_affine']),
        perm=_torch(a['perm']),
        img_affine=tuple(_torch(x) for x in a['img_affine']),
        is_aug=_torch(a['is_aug']))


def jax_fake_fakes_draws(key, gen: JaxFakeFakes, b, h, w) -> FakeFakesDraws:
    return _fake_fakes_draws(_fake_fakes_arrays(
        key, b, h, w, gen.img_aug_degree, gen.img_aug_translate,
        gen.aug_proba))


def _noise(key, b, h, w, scales, dtype):
    """make_multiscale_noise's samples (lama_tpu/training/step.py:38-52),
    NHWC."""
    return [jax.random.normal(jax.random.fold_in(key, i),
                              (b, h >> i, w >> i, 1), dtype)
            for i in range(scales)]


def jax_noise(key, b, h, w, scales, dtype):
    return [nchw(a) for a in _noise(key, b, h, w, scales, dtype)]


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _step_draw_arrays(key, b, h, w, scales, ff, dtype):
    """The draws the JAX step takes from `key` (step.py:272, 282-285), one
    program: `ff` is (proba, img_aug_degree, img_aug_translate, aug_proba)
    or None."""
    rng_g, rng_d, rng_ff = jax.random.split(key, 3)
    out = dict(g_noise=_noise(rng_g, b, h, w, scales, dtype),
               d_noise=_noise(rng_d, b, h, w, scales, dtype))
    if ff is not None:
        k_use, k_gen = jax.random.split(rng_ff)
        out['use_ff'] = jax.random.uniform(k_use, ()) < ff[0]
        out['ff'] = _fake_fakes_arrays(k_gen, b, h, w, *ff[1:])
    return out


def jax_step_draws(key, jax_step, b, h, w, dtype) -> StepDraws:
    scales = (jax_step.add_noise_kwargs.get('scales', 6)
              if jax_step.add_noise_kwargs is not None else 0)
    ff = None
    if jax_step.fake_fakes_proba > 1e-3:
        gen = jax_step.fake_fakes_gen
        ff = (jax_step.fake_fakes_proba, gen.img_aug_degree,
              gen.img_aug_translate, gen.aug_proba)
    a = _step_draw_arrays(key, b, h, w, scales, ff, dtype)
    draws = StepDraws()
    if scales:
        draws.g_noise = [nchw(x) for x in a['g_noise']]
        draws.d_noise = [nchw(x) for x in a['d_noise']]
    if ff is not None:
        draws.use_ff = bool(a['use_ff'])
        draws.ff = _fake_fakes_draws(a['ff'])
    return draws


def jax_variables(module, x, seed=0, **init_kw):
    """The variable tree of `module.init(key, x, **init_kw)`, filled from
    numpy: He-normal kernels, small biases, BatchNorm scales and running
    variances near 1, running means near 0. Flax's own init compiles for
    seconds on the CPU; the tests carry whatever variables they use across
    with `state_dict_from_flax`."""
    shapes = jax.eval_shape(functools.partial(module.init, **init_kw),
                            jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            a = rng.randn(*shape) * np.sqrt(2 / np.prod(shape[:-1]))
        elif name in ('scale', 'var'):
            a = 1 + 0.1 * rng.rand(*shape)
        else:   # bias, mean
            a = 0.1 * rng.randn(*shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_vgg19_variables(stop_after=None):
    """Variables of lama_tpu's VGG19 trunk cut before `stop_after`."""
    return jax_variables(JaxVGGFeatures(cfg=tuple(VGG19_CFG),
                                        stop_after=stop_after),
                         jnp.zeros((1, 32, 32, 3)))


# ----------------------------------------------------------------- setup
def make_batches(n_steps, seed=0):
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n_steps):
        img = rng.rand(B, S, S, 3).astype(np.float32)
        mask = np.zeros((B, S, S, 1), np.float32)
        for i in range(B):
            y, x = rng.randint(0, S // 2, size=2)
            mask[i, y:y + S // 3, x:x + S // 2] = 1
        batches.append((img, mask))
    return batches


def make_setup(group):
    """The JAX modules and float32 variables of a `group`: a dict with
    disc ('ffc_nlayer' or 'pix2pixhd_nlayer', default ffc_nlayer), disc_kw
    (extra discriminator keys), adv ('r1' or 'bce'), r1_every, vgg_weight,
    dw (distance weighter kwargs or None), dw_for_discr, ff_proba, noise
    (add_noise_kwargs or None), fill_hole, steps."""
    g = dict(dict(disc='ffc_nlayer', disc_kw={}, adv='r1', r1_every=1,
                  vgg_weight=0.0, dw=None, dw_for_discr=False, ff_proba=0.0,
                  noise=None, fill_hole=False, steps=3), **group)
    scales = (g['noise'] or {}).get('scales', 0)
    gen_kw = dict(GEN_KW, input_nc=4 + scales)
    disc_kw = dict(DISC_KW, **g['disc_kw'])
    jg = jax_generator('pix2pixhd_global', **gen_kw)
    jd = jax_discriminator(g['disc'], **disc_kw)
    batches = make_batches(g['steps'])
    gv = jax_variables(jg, jnp.zeros((B, S, S, gen_kw['input_nc'])), 0,
                       train=False)
    dv = jax_variables(jd, jnp.zeros((B, S, S, 3)), 1, train=False)
    vgg = (JaxVGG19PL(variables=jax_vgg19_variables(30))
           if g['vgg_weight'] > 0 else None)
    dw = None
    if g['dw'] and g['dw']['kind'] == 'pps':
        dw = jax_weighter(**g['dw'], vgg_variables=jax_vgg19_variables(4))
    elif g['dw']:
        dw = jax_weighter(**g['dw'])
    return dict(g, jg=jg, jd=jd, gv=gv, dv=dv, gen_kw=gen_kw, disc_kw=disc_kw,
                vgg=vgg, jdw=dw, batches=batches)


def _jax_adversarial(kind):
    if kind == 'r1':
        return jadv.make_discrim_loss('r1', **R1_KW)
    loss = jadv.make_discrim_loss('bce', weight=10)
    # lama_tpu's bce takes the mask at the score's size only (its
    # interpolate_mask asserts allow_scale_mask, which it never sets): give
    # it the r1 loss's nearest scaling, as the port's bce has
    loss.allow_scale_mask, loss.mask_scale_mode = True, 'nearest'
    return loss


def _port_adversarial(kind):
    if kind == 'r1':
        return make_discrim_loss('r1', **R1_KW)
    return make_discrim_loss('bce', weight=10, allow_scale_mask=True)


def _port_modules(setup, dtype):
    gen = make_generator('pix2pixhd_global', dtype=dtype, **setup['gen_kw'])
    gen.load_state_dict(state_dict_from_flax(
        setup['gv'], setup['gen_kw']['n_downsampling'],
        setup['gen_kw']['n_blocks'], kind='pix2pixhd_global'), strict=True)
    disc = make_discriminator(setup['disc'], dtype=dtype, **setup['disc_kw'])
    disc.load_state_dict(state_dict_from_flax(setup['dv']), strict=True)
    vgg = dw = None
    if setup['vgg'] is not None:
        vgg = VGG19PerceptualLoss(dtype=dtype)
        vgg.model.load_state_dict(state_dict_from_flax(setup['vgg'].variables),
                                  strict=True)
    if setup['dw']:
        dw = make_mask_distance_weighter(**setup['dw'])
        if setup['dw']['kind'] == 'pps':
            dw.model.load_state_dict(
                state_dict_from_flax(setup['jdw'].variables), strict=True)
            dw.to(dtype)
    gen, disc = gen.to(dtype), disc.to(dtype)
    if vgg is not None:
        vgg.to(dtype)
    return gen, disc, vgg, dw


@contextlib.contextmanager
def float64_batchnorm():
    """lama_tpu's BatchNorm computes in float32 whatever the input (its
    norm.py:48), so under x64 its generator's output still carries float32
    rounding (~1e-6 here), which the discriminator's leaky-ReLU gates and
    Adam's first step amplify. For the float64 comparison it computes in
    float64: its module's `jnp.float32` reads float64 inside this block."""
    saved = jnorm.jnp
    jnorm.jnp = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                         if not k.startswith('__')})
    jnorm.jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jnorm.jnp = saved


def run(setup, opts, dtype):
    """Both steps over the batches in `dtype` (float32 or float64): the
    per-step metrics and fake-fakes draws, the first step's clipped
    gradients (float64 only) and the state dicts after step 1."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), t)
    gv, dv = cast(setup['gv']), cast(setup['dv'])
    g_tx, d_tx = (jstate.make_optimizer(clip_grad_norm=CLIP, **o) for o in opts)
    loss_config = dict(resnet_pl_weight=0.0, perceptual_weight=setup['vgg_weight'])
    vgg_fn = None
    if setup['vgg'] is not None:
        vgg_fn = JaxVGG19PL(variables=cast(setup['vgg'].variables))
    jdw = setup['jdw']
    if jdw is not None and dtype == torch.float64:
        # lama_tpu's weighters convolve with float32 kernels, which its conv
        # refuses under a float64 input: they run in float32 there
        fp32_weighter = jdw
        jdw = lambda real, pred, mask: fp32_weighter(
            real.astype(jnp.float32), pred.astype(jnp.float32),
            mask.astype(jnp.float32)).astype(mask.dtype)
    step = jstep.InpaintingTrainStep(
        setup['jg'], setup['jd'], _jax_adversarial(setup['adv']), g_tx, d_tx,
        loss_config=jstep.LossConfig(**loss_config),
        ema=jstep.EMAConfig(enabled=False), vgg_perceptual_fn=vgg_fn,
        distance_weighter=jdw,
        distance_weighted_mask_for_discr=setup['dw_for_discr'],
        fake_fakes_proba=setup['ff_proba'],
        fake_fakes_gen=JaxFakeFakes() if setup['ff_proba'] > 1e-3 else None,
        add_noise_kwargs=setup['noise'], noise_fill_hole=setup['fill_hole'],
        r1_every=setup['r1_every'])
    state = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=gv['params'],
        g_stats=gv['batch_stats'], d_params=dv['params'],
        d_stats=dv['batch_stats'], g_opt_state=g_tx.init(gv['params']),
        d_opt_state=d_tx.init(dv['params']), ema_params=None)

    def first_grads(state, img, mask, key):
        """The fused step's G gradient and the gradient of its D objective
        (step.py:267-296), unclipped, and that objective's inputs."""
        rng_g, rng_d, rng_ff = jax.random.split(key, 3)
        (_, (_, g_stats, d_stats_g, _)), g_grads = jax.value_and_grad(
            step._generator_loss, has_aux=True)(state.g_params, state, img,
                                                mask, rng_g)
        updates, _ = g_tx.update(g_grads, state.g_opt_state, state.g_params)
        fake_fakes = use_ff = None
        if step.fake_fakes_proba > 1e-3:
            k_use, k_gen = jax.random.split(rng_ff)
            use_ff = jax.random.uniform(k_use, ()) < step.fake_fakes_proba
            fake_fakes, _ = step.fake_fakes_gen(k_gen, img, mask)
        pred, _ = step.generator_forward(
            optax.apply_updates(state.g_params, updates), g_stats, img, mask,
            rng=rng_d)
        pred = jax.lax.stop_gradient(step._to_discriminator(pred, img, mask))
        d_grads, _ = jax.grad(step._discriminator_loss, has_aux=True)(
            state.d_params, d_stats_g, img, pred, mask, fake_fakes, use_ff,
            state.step)
        return g_grads, d_grads, pred

    gen, disc, vgg, dw = _port_modules(setup, dtype)
    port = TrainState(gen, disc, make_optimizer(gen.parameters(), **opts[0]),
                      make_optimizer(disc.parameters(), **opts[1]))
    port_step = InpaintingTrainStep(
        _port_adversarial(setup['adv']),
        loss_config=LossConfig(**loss_config), ema=EMAConfig(enabled=False),
        vgg_perceptual_fn=vgg, clip_grad_norm=CLIP, distance_weighter=dw,
        distance_weighted_mask_for_discr=setup['dw_for_discr'],
        fake_fakes_proba=setup['ff_proba'],
        fake_fakes_gen=(FakeFakesGenerator() if setup['ff_proba'] > 1e-3
                        else None),
        add_noise_kwargs=setup['noise'], noise_fill_hole=setup['fill_hole'],
        r1_every=setup['r1_every'])

    if dtype == torch.float64:
        jit_step = jax.jit(lambda st, b, key: (
            step(st, b, key), first_grads(st, b['image'], b['mask'], key)))
    else:
        jit_step = jax.jit(lambda st, b, key: (step(st, b, key), None), **FAST)
    nd = setup['gen_kw']['n_downsampling'], setup['gen_kw']['n_blocks']
    out = dict(jax=[], port=[], use_ff=[])
    for i, (img, mask) in enumerate(setup['batches']):
        key = jax.random.PRNGKey(i)
        jimg, jmask = jnp.asarray(img, jdt), jnp.asarray(mask, jdt)
        (state_next, m), grads = jit_step(
            state, {'image': jimg, 'mask': jmask}, key)
        state = state_next
        out['jax'].append({k: float(v) for k, v in m.items()})
        draws = jax_step_draws(key, step, B, S, S, jdt)
        out['use_ff'].append(draws.use_ff)
        timg, tmask = nchw(img, dtype), nchw(mask, dtype)
        if i == 0 and grads is not None:
            out['jax_grads'] = [
                state_dict_from_flax({'params': clipped(grads[0])}, *nd,
                                     kind='pix2pixhd_global'),
                state_dict_from_flax({'params': clipped(grads[1])})]
            out['port_d_grads'] = _port_d_grads(
                port_step, copy.deepcopy(disc), timg, nchw(grads[2]), tmask,
                draws)
        m = port_step(port, timg, tmask, draws=draws)
        out['port'].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out['port_grads'] = [{n: p.grad.clone() for n, p in
                                  mod.named_parameters()} for mod in (gen, disc)]
            out['jax_stats'] = [
                state_dict_from_flax({'batch_stats': state.g_stats}, *nd,
                                     kind='pix2pixhd_global'),
                state_dict_from_flax({'batch_stats': state.d_stats})]
            out['port_stats'] = [{k: v.clone() for k, v in
                                  mod.state_dict().items()} for mod in (gen, disc)]
    return out


def _port_d_grads(port_step, disc, img, pred, mask, draws):
    """The port's D objective of step 0 (R1 taken) on the JAX step's D
    input `pred`, its fake fakes from the same draws; the clipped gradient
    by name."""
    fake_fakes = (port_step.fake_fakes_gen(draws.ff, img, mask)[0]
                  if draws.use_ff else None)
    disc.train()
    loss, _ = port_step.discriminator_loss(disc, img, pred, mask, take_r1=True,
                                           fake_fakes=fake_fakes)
    loss.backward()
    clip_grad_norm(list(disc.parameters()), CLIP)
    return {n: p.grad.clone() for n, p in disc.named_parameters()}


def clipped(tree):
    """optax.clip_by_global_norm(CLIP) of a gradient tree, as numpy."""
    norm = float(optax.global_norm(tree))
    scale = 1.0 if norm < CLIP else CLIP / norm
    return jax.tree_util.tree_map(lambda g: np.asarray(g) * scale, tree)


def metrics_match(run_out, required=()):
    for i, (ours, theirs) in enumerate(zip(run_out['port'], run_out['jax'])):
        assert set(ours) == set(theirs) and set(ours) >= set(required), (
            set(ours) ^ set(theirs))
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f'step {i} {k}')
    assert run_out['port'][0]['gen_total'] != run_out['port'][-1]['gen_total']


def stats_match(run_out, player, tol=1e-5):
    theirs, ours = run_out['jax_stats'][player], run_out['port_stats'][player]
    keys = [k for k in theirs if k.endswith(('running_mean', 'running_var'))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(ours[k].double().numpy(),
                                   theirs[k].double().numpy(), rtol=tol,
                                   atol=tol, err_msg=k)


def grads_match(run_out, player):
    """Player 0: the G gradient of step 0; player 1: the gradient of step
    0's D objective on the JAX step's D input (so that Adam's first G
    update, which turns any sign disagreement of a near-zero G gradient
    into a 2 x lr difference of that weight, does not reach it)."""
    ours = (run_out['port_grads'][0] if player == 0
            else run_out['port_d_grads'])
    theirs = run_out['jax_grads'][player]
    assert set(ours) == set(theirs)
    scale = max(float(np.abs(v.numpy()).max()) for v in theirs.values())
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].numpy(), v.double().numpy(),
                                   rtol=RTOL, atol=ATOL * scale, err_msg=k)
