"""The port's data parallelism (lama_tpu_torch/parallel/) against lama_tpu's
mesh step, on the CPU: worlds of 2 gloo processes (tests/torch_dp_worker.py,
one thread each, a timeout each).

- BatchNorm: 2 ranks x 2 images of a train-mode BatchNorm2d with global
  statistics equal the module on all 4 images within 1e-6: the output, the
  input and parameter gradients of a linear loss, a gradient of the input
  gradient's squared norm (the R1 penalty's shape: a gradient of a
  gradient through the statistics' all-reduce) and the running buffers,
  which also equal lama_tpu's BatchNorm on the 4 images.
- The slice: tests/test_torch_train.py's tiny big-lama setup (ngf 8, 2
  downsamplings, 2 blocks, the NLayer D, ResNetPL at weight 30, clip 1) on
  a global batch of 4 at 64^2, 3 fp32 SGD steps. The port on 2 ranks x 2
  images against lama_tpu's `shard_train_step` on a 2-device ('data',)
  mesh of the conftest's CPU devices on the global batch: every per-step
  metric (the ranks' mean) within rtol 1e-3 / atol 1e-5 and the BN running
  statistics after step 1 within 1e-5 (that file's bounds); the ranks'
  weights and buffers bit-equal after every step; and the 2-rank run equal
  to the port's own 1-process run on the global batch as torchrun launches
  it (a world of 1: the same global-statistics path) within 1e-5, metrics
  and weights, and to an unlaunched process (PyTorch's batch norm) within
  lama_tpu's bounds. Why not 1e-5 there: the two BatchNorm formulas differ
  in rounding (~1e-7), which the ReLU kinks of the generator's first
  update turn into ~1e-4 after 3 steps (tests/test_torch_train.py).
- Draws: with input noise and fake fakes, `draw` on rank r gives rows
  r*b ... (r+1)*b-1 of the global batch's draw, and the fake fakes made
  from them (their permutation over the global batch) are those rows of
  the global batch's fake fakes.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as ttt
import torch_dp_worker as dpw
from lama_tpu.losses.adversarial import make_discrim_loss as jax_discrim_loss
from lama_tpu.losses.perceptual import ResNetPL as JaxResNetPL
from lama_tpu.ops.norm import BatchNorm as JaxBatchNorm
from lama_tpu.parallel.mesh import make_mesh, put_batch, shard_train_step
from lama_tpu.training import state as jstate
from lama_tpu.training import step as jstep
from lama_tpu_torch.convert import state_dict_from_flax

torch.set_num_threads(1)

WORLD, B, S, N_STEPS = 2, 4, 64, 3   # global batch 4: 2 images a rank
BN_TOL = 1e-6
PORT_TOL = 1e-5


# ---------------------------------------------------------------- BatchNorm
def _bn_payload():
    rng = np.random.RandomState(0)
    c = 5
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    return dict(x=t(4, c, 6, 7) * 1.5 + 0.5, r=t(4, c, 6, 7),
                weight=t(c) * 0.5 + 1, bias=t(c) * 0.2,
                running_mean=t(c) * 0.1,
                running_var=torch.from_numpy(
                    rng.rand(c).astype(np.float32) + 0.5))


@pytest.fixture(scope='module')
def bn_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp('bn')
    p = _bn_payload()
    torch.save(p, str(work / 'bn_payload.pt'))
    dpw.spawn_world('bn', work, WORLD)
    ranks = [torch.load(str(work / f'bn{r}.pt')) for r in range(WORLD)]
    one = dpw.bn_case(p, None, 0, 1)
    return p, ranks, one


@pytest.mark.parametrize('key', ['out', 'dx', 'dw', 'db', 'd2x', 'd2w',
                                 'running_mean', 'running_var'])
def test_batchnorm_global_statistics_match_one_process(bn_runs, key):
    """Rows (outputs, input gradients) concatenate in rank order; the
    parameter gradients are each rank's share and sum to the whole's; the
    buffers are the same on every rank."""
    _, ranks, one = bn_runs
    if key in ('out', 'dx', 'd2x'):
        ours = torch.cat([r[key] for r in ranks])
    elif key.startswith('running'):
        assert torch.equal(ranks[0][key], ranks[1][key])
        ours = ranks[0][key]
    else:
        ours = sum(r[key] for r in ranks)
    np.testing.assert_allclose(ours.numpy(), one[key].numpy(), rtol=BN_TOL,
                               atol=BN_TOL * float(one[key].abs().max()))
    assert all(int(r['num_batches_tracked']) == 1 for r in ranks)


def test_batchnorm_global_statistics_match_jax(bn_runs):
    p, ranks, _ = bn_runs
    x = np.transpose(p['x'].numpy(), (0, 2, 3, 1))
    variables = {'params': {'scale': p['weight'].numpy(),
                            'bias': p['bias'].numpy()},
                 'batch_stats': {'mean': p['running_mean'].numpy(),
                                 'var': p['running_var'].numpy()}}
    y, new = JaxBatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=['batch_stats'])
    np.testing.assert_allclose(
        torch.cat([r['out'] for r in ranks]).numpy(),
        np.transpose(np.asarray(y), (0, 3, 1, 2)), rtol=BN_TOL, atol=BN_TOL)
    for ours, theirs in (('running_mean', 'mean'), ('running_var', 'var')):
        np.testing.assert_allclose(ranks[0][ours].numpy(),
                                   np.asarray(new['batch_stats'][theirs]),
                                   rtol=BN_TOL, atol=BN_TOL, err_msg=ours)


# ---------------------------------------------------------------- the slice
def _global_batches(n=N_STEPS, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = rng.rand(B, S, S, 3).astype(np.float32)
        mask = np.zeros((B, S, S, 1), np.float32)
        for i in range(B):
            y, x = rng.randint(0, S // 2, size=2)
            mask[i, y:y + S // 3, x:x + S // 2] = 1
        out.append((img, mask))
    return out


def _jax_mesh_run(setup, batches):
    """lama_tpu's step over a 2-device ('data',) mesh on the global
    batches: each step's metrics, and the BN statistics after step 1 as
    state dicts."""
    g_tx, d_tx = (jstate.make_optimizer(clip_grad_norm=ttt.CLIP, **o)
                  for o in ttt.SGD)
    step = jstep.InpaintingTrainStep(
        setup['g'], setup['d'], jax_discrim_loss('r1', **ttt.ADV_KW), g_tx,
        d_tx, loss_config=jstep.LossConfig(),
        ema=jstep.EMAConfig(enabled=False),
        perceptual_fn=JaxResNetPL(variables=setup['pv']))
    gv, dv = setup['gv'], setup['dv']
    state = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=gv['params'],
        g_stats=gv['batch_stats'], d_params=dv['params'],
        d_stats=dv['batch_stats'], g_opt_state=g_tx.init(gv['params']),
        d_opt_state=d_tx.init(dv['params']), ema_params=None)
    mesh = make_mesh(('data',), devices=jax.devices()[:WORLD])
    fn, state = shard_train_step(step, mesh, state)
    out = dict(metrics=[])
    for i, (img, mask) in enumerate(batches):
        state, m = fn(state, put_batch({'image': img, 'mask': mask}, mesh),
                      jax.random.PRNGKey(i))
        out['metrics'].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out['stats'] = [state_dict_from_flax(
                {'batch_stats': jax.device_get(s)})
                for s in (state.g_stats, state.d_stats)]
    return out


@pytest.fixture(scope='module')
def slice_runs(tmp_path_factory):
    """The 2-rank port world (started first, so it runs while lama_tpu's
    mesh step compiles here), lama_tpu's mesh run and the port's 1-process
    run on the same global batches and weights."""
    work = tmp_path_factory.mktemp('slice')
    setup = ttt.make_setup()
    batches = _global_batches()
    draw_img, draw_mask = _global_batches(1, seed=7)[0]
    payload = dict(
        gen_kw=ttt.GEN_KW, disc_kw=ttt.DISC_KW, adv_kw=ttt.ADV_KW,
        opts=ttt.SGD, clip=ttt.CLIP,
        gen_sd=state_dict_from_flax(setup['gv'], 2, 2),
        disc_sd=state_dict_from_flax(setup['dv']),
        pl_sd=state_dict_from_flax(setup['pv']),
        batches=batches, draw_batch=(draw_img, draw_mask))
    worlds = []
    for n in (WORLD, 1):
        (work / f'w{n}').mkdir()
        torch.save(payload, str(work / f'w{n}' / 'step_payload.pt'))
        worlds.append(dpw.start_world('step', work / f'w{n}', n))
    try:
        jax_run = _jax_mesh_run(setup, batches)
        state, step = dpw.build_step(payload)
        one = dpw.run_steps(state, step, batches)
        one['draws'] = dpw.draws_and_fake_fakes(
            dpw.draw_step(), dpw.nchw(draw_img), dpw.nchw(draw_mask))
    finally:
        for world in worlds:
            dpw.finish_world(world)
    ranks = [torch.load(str(work / f'w{WORLD}' / f'step{r}.pt'),
                        weights_only=False) for r in range(WORLD)]
    launched = torch.load(str(work / 'w1' / 'step0.pt'), weights_only=False)
    return dict(jax=jax_run, one=one, launched=launched, ranks=ranks)


def _rank_mean(ranks, i):
    keys = ranks[0]['metrics'][i].keys()
    return {k: float(np.mean([r['metrics'][i][k] for r in ranks]))
            for k in keys}


def test_two_ranks_metrics_match_jax_mesh_step(slice_runs):
    for i, theirs in enumerate(slice_runs['jax']['metrics']):
        ours = _rank_mean(slice_runs['ranks'], i)
        assert set(ours) == set(theirs) and set(ours) >= ttt.METRICS
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=ttt.RTOL,
                                       atol=ttt.ATOL, err_msg=f'step {i} {k}')
    first, last = (_rank_mean(slice_runs['ranks'], i) for i in (0, N_STEPS - 1))
    assert first['gen_total'] != last['gen_total']


@pytest.mark.parametrize('player', [0, 1], ids=['generator', 'discriminator'])
def test_two_ranks_bn_stats_after_step_one_match_jax(slice_runs, player):
    theirs = slice_runs['jax']['stats'][player]
    ours = slice_runs['ranks'][0]['state_dicts'][player]
    keys = [k for k in theirs if k.endswith(('running_mean', 'running_var'))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(ours[k].double().numpy(),
                                   theirs[k].double().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    tracked = [v for k, v in ours.items() if k.endswith('num_batches_tracked')]
    assert tracked and all(int(t) == (2 if player == 0 else 4) for t in tracked)


def test_ranks_hold_bit_equal_weights(slice_runs):
    r0, r1 = slice_runs['ranks']
    assert len(r0['digests']) == N_STEPS and r0['digests'] == r1['digests']
    assert len(set(r0['digests'])) == N_STEPS   # the weights moved each step
    for a, b in zip(r0['final'], r1['final']):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_two_ranks_match_one_process(slice_runs):
    one, ranks = slice_runs['launched'], slice_runs['ranks']
    for i in range(N_STEPS):
        ours, theirs = _rank_mean(ranks, i), one['metrics'][i]
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=PORT_TOL,
                                       atol=PORT_TOL, err_msg=f'step {i} {k}')
            np.testing.assert_allclose(
                ours[k], slice_runs['one']['metrics'][i][k], rtol=ttt.RTOL,
                atol=ttt.ATOL, err_msg=f'unlaunched, step {i} {k}')
    for when in ('state_dicts', 'final'):
        for ours, theirs in zip(ranks[0][when], one[when]):
            assert ours.keys() == theirs.keys()
            for k, v in theirs.items():
                np.testing.assert_allclose(
                    ours[k].double().numpy(), v.double().numpy(),
                    rtol=PORT_TOL, atol=PORT_TOL, err_msg=f'{when} {k}')


def test_draws_are_rows_of_the_global_draw(slice_runs):
    ref = slice_runs['one']['draws']
    b = B // WORLD
    for r, rank in enumerate(slice_runs['ranks']):
        ours = rank['draws']
        rows = slice(r * b, (r + 1) * b)
        assert ours['use_ff'] and ref['use_ff']
        for key in ('g_noise', 'd_noise'):
            assert len(ours[key]) == len(ref[key]) == 3
            for a, g in zip(ours[key], ref[key]):
                assert torch.equal(a, g[rows]), key
        for key in ('perm', 'is_aug'):
            assert torch.equal(ours[key], ref[key][rows]), key
        for key in ('mask_affine', 'img_affine'):
            for a, g in zip(ours[key], ref[key]):
                assert torch.equal(a, g[rows]), key
        np.testing.assert_allclose(ours['fake_fakes'].numpy(),
                                   ref['fake_fakes'][rows].numpy(),
                                   rtol=0, atol=1e-6)
    # some rank takes a target from the other's rows
    perms = torch.cat([rank['draws']['perm'] for rank in slice_runs['ranks']])
    assert any(int(p) // b != i // b for i, p in enumerate(perms))
