"""Validation in the port's trainer against lama_tpu's on the CPU.

Both trainers are built from configs/training/big-lama.yaml cut to a tiny
size (ngf 8, 2 downsamplings, 2 blocks, fp32, ResNetPL off), with the
generator's weights carried from the JAX trainer's state into the port's,
and validate on tests/torch_eval_common.py's 12-image dataset (64^2, val
batch 4) with the shipped evaluator (SSIM, LPIPS-vgg16, FID,
ssim_fid100_f1) on the same score-net weights:
- one validation pass gives the same metric names and values (SSIM atol
  1e-6, the others rtol 1e-3 / atol 2e-4);
- the top-k checkpoint policy keeps the same epochs, ranked alike, over
  four epochs whose monitor values include a NaN and an out-of-range one;
- the checkpoints are written where os.link raises;
- `python -m lama_tpu_torch.train` with validation data logs the val
  metrics to metrics.jsonl and writes epoch<N>.ckpt beside last.ckpt, and
  the best checkpoint serves through `python -m lama_tpu_torch.predict`.
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_eval_common import random_variables, score_setup

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, 'configs', 'training')


def overrides(root, data):
    return ['generator.ngf=8', 'generator.n_downsampling=2',
            'generator.n_blocks=2', 'discriminator.ndf=8',
            'discriminator.n_layers=2', 'data.batch_size=2',
            'data.val_batch_size=4', 'data.num_workers=1',
            'data.train.out_size=64', 'trainer.kwargs.precision=32',
            'losses.resnet_pl.weight=0', f'data.val.indir={data}',
            'data.val.img_suffix=.png', 'trainer.checkpoint_kwargs.save_top_k=2',
            f'location.data_root_dir={root}', f'location.out_root_dir={root}',
            f'location.tb_dir={root}', f'location.pretrained_models={root}']


@pytest.fixture(scope='module')
def trainers(tmp_path_factory):
    from lama_tpu.config import compose as jcompose
    from lama_tpu.training.trainer import InpaintingTrainer as JT
    from lama_tpu_torch.config import compose
    from lama_tpu_torch.convert import state_dict_from_flax
    from lama_tpu_torch.training.trainer import InpaintingTrainer
    dirs, mp = score_setup(tmp_path_factory)
    root = dirs['root']
    argv = overrides(root, dirs['data'])
    jt = JT(jcompose(CONFIG_DIR, 'big-lama', argv), os.path.join(root, 'jax'))
    # what validate reads of init_state's work (trainer.py:338-366), without
    # building the train step: the generator's variables (drawn with numpy)
    # and the eval jit
    gen_vars = random_variables(jt.generator, jnp.zeros((1, 64, 64, 4)),
                                seed=31, train=False)
    jt.state = types.SimpleNamespace(g_params=gen_vars['params'],
                                     g_stats=gen_vars['batch_stats'])
    jt._eval_forward = jax.jit(jt._eval_forward_impl)
    pt = InpaintingTrainer(compose(CONFIG_DIR, 'big-lama', argv),
                           os.path.join(root, 'port'), device='cpu')
    sd = state_dict_from_flax(jax.tree.map(np.asarray, gen_vars),
                              n_downsampling=2, n_blocks=2)
    pt.state.generator.load_state_dict(sd)
    yield dirs, jt, pt
    mp.undo()


@pytest.fixture(scope='module')
def metrics(trainers):
    _, jt, pt = trainers
    return jt.validate(0), pt.validate(0)


def test_validation_matches_jax(trainers, metrics):
    _, _, pt = trainers
    ref, ours = metrics
    assert list(ours) == list(ref)
    assert 'val_ssim_fid100_f1_total_mean' in ours
    assert 'val_fid_0_10_mean' in ours and 'val_lpips_90_100_std' in ours
    for k, want in ref.items():
        got = ours[k]
        if np.isnan(want):
            assert np.isnan(got), k
        elif '_ssim_' in k and 'fid100' not in k:
            assert abs(got - want) <= 1e-6, (k, got, want)
        else:
            assert abs(got - want) <= 2e-4 + 1e-3 * abs(want), (k, got, want)
    assert pt.state.generator.training                   # back in train mode
    assert os.path.exists(os.path.join(pt.run_dir, 'samples',
                                       'epoch0000_val', 'batch0000000.jpg'))


def test_top_k_checkpoints_match_jax(trainers, metrics):
    _, jt, pt = trainers
    ref, ours = metrics
    key = 'val_ssim_fid100_f1_total_mean'
    epochs = [(ref, ours), ({key: ref[key] - 0.1}, {key: ours[key] - 0.1}),
              ({key: float('nan')},) * 2, ({key: 1.5},) * 2,
              ({key: ref[key] + 0.05}, {key: ours[key] + 0.05})]
    for epoch, (jm, pm) in enumerate(epochs):
        jt.checkpoints.save({'step': np.zeros(1)}, epoch, jm)
        pt.checkpoints.save(pt.state, epoch, pm)
    jrec, prec = jt.checkpoints.records, pt.checkpoints.records
    assert [r['epoch'] for r in prec] == [r['epoch'] for r in jrec] == [0, 4]
    np.testing.assert_allclose([r['value'] for r in prec],
                               [r['value'] for r in jrec], rtol=1e-3)
    models = os.path.join(pt.run_dir, 'models')
    assert sorted(f for f in os.listdir(models) if f.endswith('.ckpt')) == \
        ['epoch0.ckpt', 'epoch4.ckpt', 'last.ckpt']
    assert pt.checkpoints.best_path() == os.path.join(models, 'epoch4.ckpt')
    assert os.path.basename(jt.checkpoints.best_path()) == 'epoch4'
    last = torch.load(os.path.join(models, 'last.ckpt'), weights_only=False)
    assert last['epoch'] == 4
    with open(os.path.join(models, 'index.json')) as f:
        assert [r['name'] for r in json.load(f)] == ['epoch0.ckpt', 'epoch4.ckpt']


def test_checkpoints_need_no_hard_links(trainers, tmp_path, monkeypatch):
    """A filesystem without hard links (os.link raises) still gets
    epoch<N>.ckpt and last.ckpt at every epoch."""
    from lama_tpu_torch.training.checkpoint import CheckpointManager

    def no_link(*args, **kwargs):
        raise OSError('hard links not supported')

    monkeypatch.setattr(os, 'link', no_link)
    _, _, pt = trainers
    manager = CheckpointManager(str(tmp_path), save_top_k=1)
    key = 'val_ssim_fid100_f1_total_mean'
    for epoch, value in enumerate((0.5, 0.25)):
        manager.save(pt.state, epoch, {key: value})
        last = torch.load(tmp_path / 'last.ckpt', weights_only=False)
        assert last['epoch'] == epoch
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith('.ckpt')) == \
        ['epoch0.ckpt', 'last.ckpt']
    assert manager.best_path() == str(tmp_path / 'epoch0.ckpt')


def test_train_cli_validates_and_serves_the_best_checkpoint(trainers):
    import cv2
    from lama_tpu_torch import predict, train
    from lama_tpu_torch.data.io import load_image
    dirs, _, _ = trainers
    root = os.path.join(dirs['root'], 'cli')
    os.makedirs(os.path.join(root, 'train'))
    rng = np.random.RandomState(0)
    for i in range(2):
        img = np.rint(255 * rng.rand(72, 80, 3)).astype(np.uint8)
        cv2.imwrite(os.path.join(root, 'train', f'im{i}.jpg'), img)
    run = os.path.join(root, 'run')
    argv = overrides(root, dirs['data']) + [
        f'run_dir={run}', 'trainer.kwargs.max_epochs=2',
        'trainer.kwargs.limit_train_batches=1',
        'trainer.kwargs.limit_val_batches=2', 'device=cpu']
    train.main('big-lama', argv)
    lines = [json.loads(ln) for ln in open(os.path.join(run, 'metrics.jsonl'))]
    val = [ln for ln in lines if 'val_ssim_total_mean' in ln]
    assert [ln['epoch'] for ln in val] == [0, 1]
    assert all(np.isfinite(v) for ln in val for k, v in ln.items()
               if k.endswith('total_mean'))
    models = os.path.join(run, 'models')
    assert {'epoch0.ckpt', 'epoch1.ckpt', 'last.ckpt'} <= set(os.listdir(models))
    with open(os.path.join(models, 'index.json')) as f:
        records = json.load(f)
    best = max(records, key=lambda r: r['value'])
    assert best['value'] == max(ln['val_ssim_fid100_f1_total_mean'] for ln in val)
    out = os.path.join(root, 'served')
    predict.main([f'model.path={run}', f'model.checkpoint={best["name"]}',
                  f'indir={dirs["data"]}', f'outdir={out}', 'device=cpu',
                  'precision=fp32', 'dataset.img_suffix=.png'])
    img = load_image(os.path.join(dirs['data'], 'img05.png'))
    mask = load_image(os.path.join(dirs['data'], 'img05_mask.png'), mode='L')
    got = load_image(os.path.join(out, 'img05_mask.png'))
    keep = mask[..., 0] == 0
    np.testing.assert_allclose(got[keep], img[keep], atol=1 / 255)
