"""The port's GAN training step against lama_tpu's on the CPU.

A tiny big-lama-shaped setup: generator ngf 8, 2 downsamplings, 2 blocks,
ratio 0.75; discriminator ndf 8, n_layers 2; ResNetPL with random weights at
weight 30; the big-lama losses (configs/training/big-lama.yaml); the global
norm clip at 1; batch 2 at 64^2. The JAX variables are carried into the port
with `state_dict_from_flax`; both take the same three numpy batches.

- fp32: a 3-step trajectory, SGD (lr 1e-2 G, 1e-3 D): every per-step metric
  within rtol 1e-3 / atol 1e-5, BN running statistics after step 1 within
  1e-5.
- float64: the same 3 steps with big-lama's Adam (lr 1e-3 G, 1e-4 D): the
  metrics, the first step's G and D gradients (after the clip) within rtol
  1e-3 and atol 1e-5 x the largest.
Why float64 for Adam and the gradients: in fp32 the two implementations'
forwards differ by ~1e-6 (summation order), which puts a few spectral ReLU
gates of the FourierUnits on the other side of their kink; one such gate
moves whole gradient tensors by a few percent of their largest element (the
port's own fp32 gradient moves by 6% when its input moves by 1e-5 relative),
and Adam's first steps turn any sign disagreement of a small gradient into
a 2 x lr difference of that weight. In float64 the forwards agree far
closer and the comparison is of the functions themselves. Not wholly: the
JAX BatchNorm computes in float32 even under x64 (norm.py:48), so its
rounding still reaches the gates, and Adam's first step still moves the
biases of the convs a train-mode BN follows (their gradient is zero but
for that rounding) by up to lr either way; at these weights and batches
no gate flips, and the BN statistics are held in the fp32 SGD run. SGD keeps fp32 updates linear in
the gradients, so the fp32 trajectory holds its metrics at the stated
bounds. Adam itself is held to optax on identical gradients
(tests/test_torch_train_parts.py).
`make_setup` and `_run` take the generator's kind: tests/test_torch_pix2pixhd.py
runs the fp32 SGD trajectory of a tiny GlobalGenerator through them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lama_tpu.losses.adversarial import make_discrim_loss as jax_discrim_loss
from lama_tpu.losses.perceptual import ResNetPL as JaxResNetPL
from lama_tpu.models import make_discriminator as jax_discriminator
from lama_tpu.models import make_generator as jax_generator
from lama_tpu.models.aux.resnet import ResNetDilatedEncoder
from lama_tpu.training import state as jstate
from lama_tpu.training import step as jstep
from lama_tpu_torch.convert import state_dict_from_flax
from lama_tpu_torch.losses.adversarial import make_discrim_loss
from lama_tpu_torch.losses.perceptual import ResNetPL
from lama_tpu_torch.models import make_discriminator, make_generator
from lama_tpu_torch.training.state import TrainState, make_optimizer
from lama_tpu_torch.training.step import (EMAConfig, InpaintingTrainStep,
                                          LossConfig)

torch.set_num_threads(1)

GEN_KW = dict(
    input_nc=4, output_nc=3, ngf=8, n_downsampling=2, n_blocks=2,
    add_out_act='sigmoid',
    init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75, enable_lfu=False))
DISC_KW = dict(input_nc=3, ndf=8, n_layers=2)
ADV_KW = dict(weight=10, gp_coef=0.001, mask_as_fake_target=True,
              allow_scale_mask=True)   # configs/training/big-lama.yaml
SGD = (dict(kind='sgd', lr=1e-2), dict(kind='sgd', lr=1e-3))
ADAM = (dict(kind='adam', lr=1e-3), dict(kind='adam', lr=1e-4))
CLIP = 1.0
N_STEPS, B, S = 3, 2, 64
RTOL, ATOL = 1e-3, 1e-5
# XLA's CPU backend at its lowest optimisation compiles the fp32 JAX step in
# half the time; the float64 runs keep the default, whose faster code saves
# more than the compile costs
FAST = dict(compiler_options={'xla_backend_optimization_level': 0,
                              'xla_llvm_disable_expensive_passes': True})
METRICS = {'gen_l1', 'gen_adv', 'gen_fm', 'gen_resnet_pl', 'gen_total',
           'discr_real_out', 'discr_fake_out', 'discr_real_gp', 'discr_total'}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def make_setup(kind='ffc_resnet', gen_kw=GEN_KW):
    """JAX modules and float32 variables (jitted inits) of a `kind`
    generator with `gen_kw` (2 downsamplings, 2 blocks), the
    discriminator and the ResNet; the batches."""
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(N_STEPS):
        img = rng.rand(B, S, S, 3).astype(np.float32)
        mask = np.zeros((B, S, S, 1), np.float32)
        for i in range(B):
            y, x = rng.randint(0, S // 2, size=2)
            mask[i, y:y + S // 3, x:x + S // 2] = 1
        batches.append((img, mask))
    g = jax_generator(kind, **gen_kw)
    d = jax_discriminator('pix2pixhd_nlayer', **DISC_KW)
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    img0, mask0 = (jnp.asarray(a) for a in batches[0])
    gv = jax.jit(g.init, static_argnames='train')(
        kg, jnp.concatenate([img0 * (1 - mask0), mask0], -1), train=False)
    dv = jax.jit(d.init, static_argnames='train')(kd, img0, train=False)
    pv = jax.jit(ResNetDilatedEncoder().init, static_argnames='train')(
        jax.random.PRNGKey(1), jnp.zeros((1, S, S, 3)), train=False)
    return dict(g=g, d=d, gv=gv, dv=dv, pv=pv, batches=batches, kind=kind,
                gen_kw=gen_kw)


@pytest.fixture(scope='module')
def setup():
    return make_setup()


def _run(setup, opts, dtype):
    """Both steps over the batches in `dtype` (float32 or float64): the
    per-step metrics, the first step's clipped gradients (float64 only) and
    the state dicts after step 1."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), t)
    gv, dv, pv = cast(setup['gv']), cast(setup['dv']), cast(setup['pv'])
    g_tx, d_tx = (jstate.make_optimizer(clip_grad_norm=CLIP, **o) for o in opts)
    step = jstep.InpaintingTrainStep(
        setup['g'], setup['d'], jax_discrim_loss('r1', **ADV_KW), g_tx, d_tx,
        loss_config=jstep.LossConfig(), ema=jstep.EMAConfig(enabled=False),
        perceptual_fn=JaxResNetPL(variables=pv))
    state = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=gv['params'],
        g_stats=gv['batch_stats'], d_params=dv['params'],
        d_stats=dv['batch_stats'], g_opt_state=g_tx.init(gv['params']),
        d_opt_state=d_tx.init(dv['params']), ema_params=None)

    def first_grads(state, img, mask):
        """The fused step's two gradients (step.py:274-296), unclipped."""
        (_, (_, g_stats, d_stats_g, _)), g_grads = jax.value_and_grad(
            step._generator_loss, has_aux=True)(state.g_params, state, img, mask)
        updates, _ = g_tx.update(g_grads, state.g_opt_state, state.g_params)
        pred, _ = step.generator_forward(
            optax.apply_updates(state.g_params, updates), g_stats, img, mask)
        d_grads, _ = jax.grad(step._discriminator_loss, has_aux=True)(
            state.d_params, d_stats_g, img, jax.lax.stop_gradient(pred), mask,
            step=state.step)
        return g_grads, d_grads

    kind = setup['kind']
    gen = make_generator(kind, dtype=dtype, **setup['gen_kw'])
    gen.load_state_dict(state_dict_from_flax(setup['gv'], 2, 2, kind=kind),
                        strict=True)
    disc = make_discriminator('pix2pixhd_nlayer', dtype=dtype, **DISC_KW)
    disc.load_state_dict(state_dict_from_flax(setup['dv']), strict=True)
    pl = ResNetPL(allow_random_weights=True, dtype=dtype)
    pl.impl.load_state_dict(state_dict_from_flax(setup['pv']), strict=True)
    gen, disc, pl = gen.to(dtype), disc.to(dtype), pl.to(dtype)
    port = TrainState(gen, disc, make_optimizer(gen.parameters(), **opts[0]),
                      make_optimizer(disc.parameters(), **opts[1]))
    port_step = InpaintingTrainStep(
        make_discrim_loss('r1', **ADV_KW), loss_config=LossConfig(),
        ema=EMAConfig(enabled=False), perceptual_fn=pl, clip_grad_norm=CLIP)

    out = dict(jax=[], port=[])
    if dtype == torch.float64:
        # one program for the step and its gradients (one compile, not two)
        jit_step = jax.jit(lambda st, b, key: (
            step(st, b, key), first_grads(st, b['image'], b['mask'])))
    else:
        jit_step = jax.jit(lambda st, b, key: (step(st, b, key), None), **FAST)
    for i, (img, mask) in enumerate(setup['batches']):
        jimg, jmask = jnp.asarray(img, jdt), jnp.asarray(mask, jdt)
        (state_next, m), grads = jit_step(
            state, {'image': jimg, 'mask': jmask}, jax.random.PRNGKey(i))
        if i == 0 and grads is not None:
            out['jax_grads'] = [
                state_dict_from_flax({'params': _clipped(t)}, *nd)
                for t, nd in zip(grads, ((2, 2, kind), (0, 0)))]
        state = state_next
        out['jax'].append({k: float(v) for k, v in m.items()})
        m = port_step(port, _nchw(img).to(dtype), _nchw(mask).to(dtype))
        out['port'].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out['port_grads'] = [{n: p.grad.clone() for n, p in
                                  mod.named_parameters()} for mod in (gen, disc)]
            out['jax_stats'] = [state_dict_from_flax({'batch_stats': s})
                                for s in (state.g_stats, state.d_stats)]
            out['port_stats'] = [{k: v.clone() for k, v in
                                  mod.state_dict().items()} for mod in (gen, disc)]
    return out


def _clipped(tree):
    """optax.clip_by_global_norm(CLIP) of a gradient tree, as numpy."""
    norm = float(optax.global_norm(tree))
    scale = 1.0 if norm < CLIP else CLIP / norm
    return jax.tree_util.tree_map(lambda g: np.asarray(g) * scale, tree)


@pytest.fixture(scope='module')
def fp32_sgd(setup):
    return _run(setup, SGD, torch.float32)


@pytest.fixture(scope='module')
def fp64_adam(setup):
    with jax.enable_x64(True):
        return _run(setup, ADAM, torch.float64)


def _metrics_match(run):
    for i, (ours, theirs) in enumerate(zip(run['port'], run['jax'])):
        assert set(ours) == set(theirs) and set(ours) >= METRICS, (
            set(ours) ^ set(theirs))
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f'step {i} {k}')
    assert run['port'][0]['gen_total'] != run['port'][-1]['gen_total']


def _stats_match(run, player, tol):
    theirs, ours = run['jax_stats'][player], run['port_stats'][player]
    keys = [k for k in theirs if k.endswith(('running_mean', 'running_var'))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(ours[k].double().numpy(),
                                   theirs[k].double().numpy(), rtol=tol,
                                   atol=tol, err_msg=k)
    # per step: twice for the generator (G step, the D step's re-forward);
    # four times for the discriminator (reals, fakes in each step)
    tracked = [v for k, v in ours.items() if k.endswith('num_batches_tracked')]
    assert tracked and all(int(t) == (2 if player == 0 else 4) for t in tracked)


def test_fp32_sgd_trajectory_metrics_match_jax(fp32_sgd):
    _metrics_match(fp32_sgd)


@pytest.mark.parametrize('player', [0, 1], ids=['generator', 'discriminator'])
def test_fp32_bn_running_stats_after_step_one_match_jax(fp32_sgd, player):
    _stats_match(fp32_sgd, player, 1e-5)


def test_fp64_adam_trajectory_metrics_match_jax(fp64_adam):
    _metrics_match(fp64_adam)


@pytest.mark.parametrize('player', [0, 1], ids=['generator', 'discriminator'])
def test_fp64_first_step_gradients_match_jax(fp64_adam, player):
    ours, theirs = fp64_adam['port_grads'][player], fp64_adam['jax_grads'][player]
    assert set(ours) == set(theirs)
    scale = max(float(np.abs(v.numpy()).max()) for v in theirs.values())
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].numpy(), v.double().numpy(),
                                   rtol=RTOL, atol=ATOL * scale, err_msg=k)
