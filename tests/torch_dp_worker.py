"""One rank of a data-parallel world of the port on the CPU (gloo), run by
tests/test_torch_parallel.py and tests/test_torch_multihost_trainer.py:

    python tests/torch_dp_worker.py MODE --rank R --world W \
        --init tcp://127.0.0.1:PORT --workdir DIR

It reads its inputs from DIR (written by the test), writes its results to
DIR/<mode><rank>.pt (or .json) and imports nothing of jax or lama_tpu.
Modes:
  bn    a train-mode BatchNorm2d with global statistics on this rank's
        rows: output, the gradients of a linear loss, a gradient of the
        input gradient's squared norm (R1's shape), the running buffers;
  step  the tiny big-lama train step of tests/test_torch_train.py on this
        rank's rows of each global batch (fp32 SGD): each step's metrics,
        a digest of the weights after each step, the state dicts after
        step 1; and the draws of a step with input noise and fake fakes,
        with the fake fakes they make;
  fit   `python -m lama_tpu_torch.train`'s main on tiny synthetic data
        (train shards, one validation), then a resume from its last.ckpt
        into a run dir of this rank's own.
Every collective has the world's timeout, so a failing rank ends the
others too.
"""
import argparse
import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

TIMEOUT_S = 120          # each collective's, in a worker
WORLD_TIMEOUT_S = 400    # a whole world's, in the test


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def start_world(mode, workdir, world=2):
    """`world` worker processes of `mode` on a fresh port, started."""
    import subprocess
    init = f'tcp://127.0.0.1:{free_port()}'
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, '--rank', str(r),
         '--world', str(world), '--init', init, '--workdir', str(workdir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def finish_world(procs, timeout=WORLD_TIMEOUT_S):
    """Wait for the workers (killing any still running at the timeout)
    and fail with the output of any that did not exit 0."""
    import time
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} exited {p.returncode}:\n{out[-4000:]}'


def spawn_world(mode, workdir, world=2):
    finish_world(start_world(mode, workdir, world))


def weights_digest(*modules) -> str:
    """sha256 of every parameter and buffer's bytes, in order."""
    h = hashlib.sha256()
    for m in modules:
        for t in (*m.parameters(), *m.buffers()):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def build_step(payload, group=None, dtype=torch.float32):
    """The port's modules, optimizers and step of tests/test_torch_train.py's
    `_run` from `payload` (its kwargs and state dicts); with `group`, data
    parallel over it."""
    from lama_tpu_torch.losses.adversarial import make_discrim_loss
    from lama_tpu_torch.losses.perceptual import ResNetPL
    from lama_tpu_torch.models import make_discriminator, make_generator
    from lama_tpu_torch.parallel.data_parallel import (replicate_,
                                                       sync_batchnorm_)
    from lama_tpu_torch.training.state import TrainState, make_optimizer
    from lama_tpu_torch.training.step import (EMAConfig, InpaintingTrainStep,
                                              LossConfig)
    gen = make_generator('ffc_resnet', dtype=dtype, **payload['gen_kw'])
    gen.load_state_dict(payload['gen_sd'], strict=True)
    disc = make_discriminator('pix2pixhd_nlayer', dtype=dtype,
                              **payload['disc_kw'])
    disc.load_state_dict(payload['disc_sd'], strict=True)
    pl = ResNetPL(allow_random_weights=True, dtype=dtype)
    pl.impl.load_state_dict(payload['pl_sd'], strict=True)
    if group is not None:
        for m in (gen, disc):
            sync_batchnorm_(m, group)
        replicate_((gen, disc), group)
    opts = payload['opts']
    state = TrainState(gen, disc, make_optimizer(gen.parameters(), **opts[0]),
                       make_optimizer(disc.parameters(), **opts[1]))
    step = InpaintingTrainStep(
        make_discrim_loss('r1', **payload['adv_kw']), loss_config=LossConfig(),
        ema=EMAConfig(enabled=False), perceptual_fn=pl,
        clip_grad_norm=payload['clip'], group=group)
    return state, step


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def run_steps(state, step, batches, rank=0, world=1):
    """The step on rows rank*b...(rank+1)*b-1 of each global NHWC batch:
    per-step metrics (this rank's means), the weights' digest after each
    step, and the state dicts of G and D after step 1."""
    from lama_tpu_torch.parallel.data_parallel import global_rows
    out = dict(metrics=[], digests=[])
    for i, (img, mask) in enumerate(batches):
        m = step(state, global_rows(nchw(img), rank, world),
                 global_rows(nchw(mask), rank, world))
        out['metrics'].append({k: float(v) for k, v in m.items()})
        out['digests'].append(weights_digest(state.generator,
                                             state.discriminator))
        if i == 0:
            out['state_dicts'] = [
                {k: v.clone() for k, v in mod.state_dict().items()}
                for mod in (state.generator, state.discriminator)]
    out['final'] = [{k: v.clone() for k, v in mod.state_dict().items()}
                    for mod in (state.generator, state.discriminator)]
    return out


def draw_step(group=None):
    """A step with 3 scales of input noise and fake fakes at probability
    1, for draws only."""
    from lama_tpu_torch.losses.adversarial import make_discrim_loss
    from lama_tpu_torch.models.fake_fakes import FakeFakesGenerator
    from lama_tpu_torch.training.step import InpaintingTrainStep
    return InpaintingTrainStep(
        make_discrim_loss('r1', weight=10, gp_coef=0.001),
        add_noise_kwargs=dict(scales=3), fake_fakes_proba=1.0,
        fake_fakes_gen=FakeFakesGenerator(), seed=3, group=group)


def draws_and_fake_fakes(step, img, mask, step_i=5):
    """The step's draws for (img, mask) (NCHW) at step `step_i` and the
    fake fakes they make (on the global batch, gathered)."""
    from lama_tpu_torch.parallel.data_parallel import gather_rows
    draws = step.draw(step_i, img)
    fake = step.fake_fakes_gen(draws.ff, img, mask,
                               pool=gather_rows(img, step.group))[0]
    ff = draws.ff
    return dict(g_noise=draws.g_noise, d_noise=draws.d_noise,
                use_ff=draws.use_ff, perm=ff.perm, is_aug=ff.is_aug,
                mask_affine=ff.mask_affine, img_affine=ff.img_affine,
                fake_fakes=fake)


# ------------------------------------------------------------------- modes
def mode_bn(args, group, rank, world):
    p = torch.load(os.path.join(args.workdir, 'bn_payload.pt'))
    torch.save(bn_case(p, group, rank, world),
               os.path.join(args.workdir, f'bn{rank}.pt'))


def bn_case(p, group, rank, world):
    """Train-mode BatchNorm2d on this rank's rows of p['x']: the output, the
    gradients of sum(out * r) w.r.t. the input, weight and bias, those of
    the input gradient's squared sum w.r.t. the input and weight, the
    buffers.
    Parameter gradients are this rank's share (summed over the ranks they
    are the whole batch's)."""
    from lama_tpu_torch.ops.norm import BatchNorm2d
    from lama_tpu_torch.parallel.data_parallel import (global_rows,
                                                       sync_batchnorm_)
    bn = BatchNorm2d(p['x'].shape[1])
    with torch.no_grad():
        bn.weight.copy_(p['weight'])
        bn.bias.copy_(p['bias'])
        bn.running_mean.copy_(p['running_mean'])
        bn.running_var.copy_(p['running_var'])
    if group is not None:
        sync_batchnorm_(bn, group)
    x = global_rows(p['x'], rank, world).clone().requires_grad_(True)
    r = global_rows(p['r'], rank, world)
    out = bn(x)
    dx, dw, db = torch.autograd.grad((out * r).sum(), [x, bn.weight, bn.bias],
                                     create_graph=True)
    # the input gradient does not depend on the bias
    d2x, d2w = torch.autograd.grad(dx.square().sum(), [x, bn.weight])
    return dict(out=out.detach(), dx=dx.detach(), dw=dw.detach(),
                db=db.detach(), d2x=d2x, d2w=d2w,
                running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone(),
                num_batches_tracked=bn.num_batches_tracked.clone())


def mode_step(args, group, rank, world):
    p = torch.load(os.path.join(args.workdir, 'step_payload.pt'),
                   weights_only=False)
    state, step = build_step(p, group)
    out = run_steps(state, step, p['batches'], rank, world)
    img, mask = (nchw(a) for a in p['draw_batch'])
    from lama_tpu_torch.parallel.data_parallel import global_rows
    out['draws'] = draws_and_fake_fakes(
        draw_step(group), global_rows(img, rank, world),
        global_rows(mask, rank, world))
    torch.save(out, os.path.join(args.workdir, f'step{rank}.pt'))


def mode_fit(args, group, rank, world):
    from lama_tpu_torch import train as port_train
    from lama_tpu_torch.parallel import multihost
    from lama_tpu_torch.training.trainer import InpaintingTrainer
    from lama_tpu_torch.config import compose
    with open(os.path.join(args.workdir, 'fit_args.json')) as f:
        overrides = json.load(f)
    # web shards on 2 ranks need a fixed epoch length
    web = InpaintingTrainer(compose(port_train.CONFIG_DIR, 'big-lama', overrides + [
        'data.train.kind=default_web', 'trainer.kwargs.limit_train_batches=null',
        f'data.train.indir={args.workdir}/shard{{0..1}}.tar']),
        os.path.join(args.workdir, f'web{rank}'), device='cpu')
    try:
        web.train_dataloader()
        web_without_limit = 'no error'
    except ValueError as e:
        web_without_limit = f'ValueError: {e}'
    trainer = port_train.main('big-lama', overrides)
    loader = trainer.train_dataloader()
    loader.set_epoch(0)
    order, n_batches = loader._indices()
    rec = dict(run_dir=trainer.run_dir, step=trainer.global_step,
               web_without_limit=web_without_limit,
               digest=weights_digest(trainer.generator, trainer.discriminator),
               train_items=[str(loader.dataset.in_files[i]) for i in order],
               train_batches=n_batches)
    multihost.barrier()
    # resume from rank 0's last.ckpt into a run dir of this rank's own: the
    # same file restored on every rank, and only rank 0 writes
    resumed = InpaintingTrainer(
        trainer.config, os.path.join(args.workdir, f'resume{rank}'),
        device='cpu')
    resumed.max_epochs = 2
    resumed.fit(resume_from=os.path.join(trainer.run_dir, 'models',
                                         'last.ckpt'))
    rec.update(resumed_step=resumed.global_step,
               resumed_digest=weights_digest(resumed.generator,
                                             resumed.discriminator))
    torch.save(trainer.generator.state_dict(),
               os.path.join(args.workdir, f'fit_generator{rank}.pt'))
    with open(os.path.join(args.workdir, f'fit{rank}.json'), 'w') as f:
        json.dump(rec, f)


MODES = dict(bn=mode_bn, step=mode_step, fit=mode_fit)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('mode', choices=sorted(MODES))
    parser.add_argument('--rank', type=int, required=True)
    parser.add_argument('--world', type=int, required=True)
    parser.add_argument('--init', required=True)
    parser.add_argument('--workdir', required=True)
    args = parser.parse_args()
    torch.set_num_threads(1)
    from lama_tpu_torch.parallel import multihost
    multihost.maybe_initialize_distributed(
        init_method=args.init, world_size=args.world, rank=args.rank,
        device='cpu', timeout=TIMEOUT_S)
    try:
        MODES[args.mode](args, multihost.world_group(), args.rank, args.world)
    finally:
        multihost.shutdown()
    print(f'{args.mode} rank {args.rank}: OK', flush=True)


if __name__ == '__main__':
    main()
