"""A 2-process `InpaintingTrainer.fit` of the port on the CPU (gloo), the
counterpart of tests/test_multihost.py::test_two_process_full_trainer_fit.

Two ranks of tests/torch_dp_worker.py (mode `fit`) run `python -m
lama_tpu_torch.train`'s main on big-lama cut to a tiny size (ngf 8, 2
downsamplings, 2 blocks, ndf 8, 2 layers, fp32, ResNetPL off), 2 images a
rank at 64^2 from 8 synthetic JPEGs, 2 steps, then one validation (SSIM
and LPIPS, FID off) on 5 images at val batch 2, then a resume from the
run's last.ckpt into a run dir of each rank's own:
- one run dir for both ranks (the time-stamped template, resolved on rank
  0), in which metrics.jsonl holds each step once;
- the ranks' train shards are disjoint and cover the set;
- the merged validation equals a 1-process validation of the same val set
  with the trained generator within 1e-6;
- the ranks' weights are bit-equal after the fit and after the resume,
  which continues on both ranks; only rank 0 writes (models/,
  metrics.jsonl, samples);
- web shards with 2 ranks and no limit_train_batches raise.
In this process: `trainer.kwargs.gpus=2` unlaunched raises with the
torchrun hint, and the loaders' shards are disjoint, cover the data and
draw their augmentations per rank.
"""
import glob
import json
import os
import tarfile

import numpy as np
import pytest
import torch

import torch_dp_worker as dpw
from lama_tpu_torch.config import compose
from lama_tpu_torch.data.datasets import (BatchLoader, InpaintingTrainDataset,
                                          InpaintingTrainWebDataset)
from lama_tpu_torch.data.io import save_image
from lama_tpu_torch.data.masks import get_mask_generator
from lama_tpu_torch.data.transforms import get_transforms
from lama_tpu_torch.training.trainer import InpaintingTrainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, 'configs', 'training')
N_TRAIN, N_VAL = 8, 5
VAL_TOL = 1e-6


def _write_data(root):
    import cv2
    rng = np.random.RandomState(0)
    os.makedirs(root / 'train')
    for i in range(N_TRAIN):
        img = rng.rand(72, 80, 3)
        cv2.imwrite(str(root / 'train' / f'im{i}.jpg'),
                    np.rint(img * 255).astype(np.uint8))
    for n in range(2):
        with tarfile.open(str(root / f'shard{n}.tar'), 'w') as tf:
            for i in range(n, N_TRAIN, 2):
                tf.add(str(root / 'train' / f'im{i}.jpg'), arcname=f'im{i}.jpg')
    for i in range(N_VAL):
        mask = np.zeros((64, 64, 1))
        mask[8 + 4 * i:40, 10:50] = 1
        save_image(str(root / 'val' / f'v{i}.png'), rng.rand(64, 64, 3))
        save_image(str(root / 'val' / f'v{i}_mask.png'), mask)


def _overrides(root):
    return ['generator.ngf=8', 'generator.n_downsampling=2',
            'generator.n_blocks=2', 'discriminator.ndf=8',
            'discriminator.n_layers=2', 'data.batch_size=2',
            'data.val_batch_size=2', 'data.num_workers=1',
            'data.train.out_size=64', 'trainer.kwargs.precision=32',
            'trainer.kwargs.max_epochs=1',
            'trainer.kwargs.limit_train_batches=2',
            'trainer.kwargs.log_every_n_steps=1',
            'trainer.kwargs.gpus=2', 'losses.resnet_pl.weight=0',
            f'data.val.indir={root / "val"}', 'data.val.img_suffix=.png',
            'evaluator.fid=false', 'evaluator.integral_kind=null',
            'trainer.checkpoint_kwargs.monitor=val_ssim_total_mean',
            f'location.data_root_dir={root}',
            f'location.out_root_dir={root / "runs"}',
            f'location.tb_dir={root}', f'location.pretrained_models={root}',
            'device=cpu']


@pytest.fixture(scope='module')
def fit(tmp_path_factory):
    root = tmp_path_factory.mktemp('fit')
    _write_data(root)
    with open(root / 'fit_args.json', 'w') as f:
        json.dump(_overrides(root), f)
    dpw.spawn_world('fit', root, 2)
    ranks = []
    for r in range(2):
        with open(root / f'fit{r}.json') as f:
            ranks.append(json.load(f))
    return root, ranks


def test_ranks_share_one_run_dir_that_rank_0_writes(fit):
    root, ranks = fit
    assert ranks[0]['run_dir'] == ranks[1]['run_dir']
    assert glob.glob(str(root / 'runs' / '*')) == [ranks[0]['run_dir']]
    run = ranks[0]['run_dir']
    for name in ('config.yaml', 'metrics.jsonl', 'models/last.ckpt',
                 'models/epoch0.ckpt'):
        assert os.path.isfile(os.path.join(run, name)), name
    lines = [json.loads(ln) for ln in open(os.path.join(run, 'metrics.jsonl'))]
    train = [ln['step'] for ln in lines if 'gen_total' in ln]
    assert train == [0, 1]   # once each: rank 1 writes no line
    assert sum('val_ssim_total_mean' in ln for ln in lines) == 1


def test_train_shards_are_disjoint_and_cover_the_set(fit):
    _, ranks = fit
    items = [set(r['train_items']) for r in ranks]
    assert all(len(s) == N_TRAIN // 2 for s in items)
    assert not items[0] & items[1] and len(items[0] | items[1]) == N_TRAIN
    assert [r['train_batches'] for r in ranks] == [2, 2]


def test_merged_validation_equals_one_process(fit):
    root, ranks = fit
    run = ranks[0]['run_dir']
    lines = [json.loads(ln) for ln in open(os.path.join(run, 'metrics.jsonl'))]
    merged = [ln for ln in lines if 'val_ssim_total_mean' in ln][0]
    overrides = [o for o in _overrides(root) if 'gpus' not in o]
    one = InpaintingTrainer(compose(CONFIG_DIR, 'big-lama', overrides),
                            str(root / 'one'), device='cpu')
    one.state.generator.load_state_dict(
        torch.load(str(root / 'fit_generator0.pt')))
    theirs = one.validate(0)
    assert theirs and 'val_lpips_total_mean' in theirs
    ours = {k: v for k, v in merged.items() if k.startswith('val_')}
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, rtol=VAL_TOL, atol=VAL_TOL,
                                   err_msg=k)


def test_weights_bit_equal_and_resume_continues_on_both_ranks(fit):
    root, ranks = fit
    assert [r['step'] for r in ranks] == [2, 2]
    assert ranks[0]['digest'] == ranks[1]['digest']
    assert [r['resumed_step'] for r in ranks] == [4, 4]
    assert ranks[0]['resumed_digest'] == ranks[1]['resumed_digest']
    assert ranks[0]['resumed_digest'] != ranks[0]['digest']
    assert os.path.isfile(root / 'resume0' / 'models' / 'last.ckpt')
    assert os.path.isfile(root / 'resume0' / 'metrics.jsonl')
    assert not os.path.exists(root / 'resume1')   # rank 1 writes nothing
    assert all(r['web_without_limit'].startswith('ValueError')
               and 'limit_train_batches' in r['web_without_limit']
               for r in ranks), [r['web_without_limit'] for r in ranks]


def test_more_gpus_than_the_launched_world_raise(tmp_path):
    config = compose(CONFIG_DIR, 'big-lama',
                     [o for o in _overrides(tmp_path)
                      if 'gpus' not in o] + ['trainer.kwargs.gpus=2'])
    with pytest.raises(NotImplementedError,
                       match='torchrun --nproc_per_node 2'):
        InpaintingTrainer(config, str(tmp_path / 'never'), device='cpu')
    assert not os.path.exists(tmp_path / 'never')


def test_loaders_shard_disjointly_with_per_rank_streams(tmp_path):
    """The train loader's shards (shuffled, strided), the val loader's
    (contiguous, rank order = data order) and the web shards
    (round-robin) are disjoint and cover the data; a rank's augmentation
    and mask stream is its own."""
    _write_data(tmp_path)
    ds = InpaintingTrainDataset(
        str(tmp_path / 'train'),
        get_mask_generator(kind='mixed', kwargs=dict(segm_proba=0)),
        get_transforms('default', 64), seed=3)
    for contiguous in (False, True):
        shards = [BatchLoader(ds, batch_size=2, shuffle=not contiguous,
                              shard_id=r, num_shards=2,
                              shard_contiguous=contiguous)._indices()[0]
                  for r in range(2)]
        assert not set(shards[0]) & set(shards[1])
        assert sorted(np.concatenate(shards)) == list(range(N_TRAIN))
        if contiguous:
            assert list(np.concatenate(shards)) == list(range(N_TRAIN))
    a, b = (ds.fetch(0, 0, r) for r in range(2))
    assert not np.array_equal(a['mask'], b['mask'])
    for r in range(2):
        again = ds.fetch(0, 0, r)
        assert np.array_equal(again['image'], (a, b)[r]['image'])
    for n in range(4):
        tarfile.open(str(tmp_path / f's{n}.tar'), 'w').close()
    web = [InpaintingTrainWebDataset(
        str(tmp_path / 's{0..3}.tar'), None, None, shard_id=r,
        num_shards=2).shards for r in range(2)]
    assert not set(web[0]) & set(web[1]) and len(web[0] + web[1]) == 4
