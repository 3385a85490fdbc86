"""The port's host-side training data paths against lama_tpu's, on the same
files and seeds (equal results, exactly):
- the web-shard train loader (`default_web`: tar shards, shuffle buffer,
  `set_epoch`, a fixed number of batches an epoch) and the shard patterns;
- `img_with_segm` (images with their one-hot ADE20k segmentation);
- the `online` val set (masks generated on load) and val over a list of
  directories;
- the constant-area crop and the rescale ramp on a batch (the trainer's
  host curricula, shared and per-host streams), the uint8 wire and its
  /255 on the device;
- `trainer.kwargs.steps_per_dispatch=2` trains as two single steps do.
"""
import os
import tarfile
import types

import cv2
import numpy as np
import pytest
import torch

from lama_tpu.data import datasets as jdatasets
from lama_tpu.training.trainer import InpaintingTrainer as JaxTrainer
from lama_tpu.utils import ramps as jramps
from lama_tpu_torch import train as port_train
from lama_tpu_torch.data import datasets as tdatasets
from lama_tpu_torch.training.trainer import InpaintingTrainer
from lama_tpu_torch.utils import ramps as tramps

torch.set_num_threads(1)

MASKS = dict(irregular_proba=1, irregular_kwargs=dict(max_times=3),
             box_proba=1, box_kwargs=dict(margin=5, bbox_min_size=10,
                                          bbox_max_size=30),
             segm_proba=0)


def _write_images(root, n, ext='.jpg', seed=3):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        img = (rng.rand(60 + 2 * i, 72, 3) * 255).astype(np.uint8)
        paths.append(os.path.join(root, f'im{i:02d}{ext}'))
        cv2.imwrite(paths[-1], img)
    return paths


def _same_batches(ours, theirs, n):
    pairs = list(zip(ours, theirs))
    assert len(pairs) == n
    for a, b in pairs:
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return pairs


def test_web_loader_matches_jax(tmp_path):
    paths = _write_images(str(tmp_path / 'img'), 9)
    for s in range(3):
        with tarfile.open(str(tmp_path / f'part{s:05d}.tar'), 'w') as tf:
            for p in paths[s::3]:
                tf.add(p, arcname=os.path.basename(p))
    pattern = str(tmp_path / 'part{00000..00002}.tar')
    assert tdatasets.expand_shards(pattern) == jdatasets.expand_shards(pattern)
    assert len(tdatasets.expand_shards(pattern)) == 3
    kw = dict(indir=pattern, kind='default_web', out_size=32,
              mask_gen_kwargs=MASKS, transform_variant='distortions',
              shuffle_buffer=4, seed=7,
              dataloader_kwargs=dict(batch_size=2, epoch_batches=6))
    ours = tdatasets.make_default_train_dataloader(**kw)
    theirs = jdatasets.make_default_train_dataloader(**kw)
    assert isinstance(ours, tdatasets.IterableBatchLoader)
    firsts = []
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        pairs = _same_batches(ours, theirs, 6)   # 9 images cycled to 12
        firsts.append(pairs[0][0]['image'])
    assert not np.array_equal(*firsts)   # set_epoch reshuffles


def test_img_with_segm_matches_jax(tmp_path):
    _write_images(str(tmp_path / 'img'), 3)
    os.makedirs(tmp_path / 'segm')
    rng = np.random.RandomState(4)
    for i in range(3):
        cv2.imwrite(str(tmp_path / 'segm' / f'im{i:02d}.png'),
                    rng.randint(0, 151, (60 + 2 * i, 72)).astype(np.uint8))
    kw = dict(indir=str(tmp_path / 'img'), kind='img_with_segm', out_size=32,
              mask_gen_kwargs=MASKS, transform_variant='default',
              segm_indir=str(tmp_path / 'segm'),
              dataloader_kwargs=dict(batch_size=3, num_workers=1))
    ours = tdatasets.make_default_train_dataloader(
        **kw, rng=np.random.RandomState(0))
    theirs = jdatasets.make_default_train_dataloader(
        **kw, rng=np.random.RandomState(0))
    (a, _), = _same_batches(ours, theirs, 1)
    assert a['segm'].shape == (3, 32, 32, 150)
    np.testing.assert_array_equal(a['segm'].sum(-1), 1)


def test_online_val_sets_match_jax(tmp_path):
    for d in ('a', 'b'):
        _write_images(str(tmp_path / d), 2, ext='.png', seed=ord(d))
    kw = dict(kind='online', img_suffix='.png', mask_gen_kwargs=MASKS,
              pad_out_to_modulo=8)
    for indir in (str(tmp_path / 'a'), [str(tmp_path / 'a'), str(tmp_path / 'b')]):
        ours = tdatasets.make_default_val_dataset(
            indir, rng=np.random.RandomState(1), **kw)
        theirs = jdatasets.make_default_val_dataset(
            indir, rng=np.random.RandomState(1), **kw)
        assert len(ours) == len(theirs) == (2 if isinstance(indir, str) else 4)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert sorted(a) == sorted(b) == ['image', 'mask']
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a['mask'].max() == 1 and a['image'].shape[0] % 8 == 0


@pytest.mark.parametrize('seed', [0, 5])
def test_constant_area_crop_params_match_jax(seed):
    ours, theirs = np.random.RandomState(seed), np.random.RandomState(seed)
    for h, w in ((256, 256), (300, 200), (100, 512)):
        for _ in range(20):
            kw = dict(img_height=h, img_width=w, min_size=64, max_size=256,
                      area=128 * 128, round_to_mod=16)
            assert tdatasets.make_constant_area_crop_params(rng=ours, **kw) == \
                jdatasets.make_constant_area_crop_params(rng=theirs, **kw)


def _curricula(seed):
    return types.SimpleNamespace(
        rescale_size_getter=None, const_area_crop_kwargs=dict(
            min_size=32, max_size=64, area=48 * 48, round_to_mod=16),
        _shared_rng=np.random.RandomState(seed),
        _host_rng=np.random.RandomState(seed + 7919 * 0), global_step=0)


def test_host_curricula_match_jax():
    """The rescale ramp (a ladder) and the constant-area crop on one batch,
    step by step: the port's `prepare_train_batch` against lama_tpu's
    `_prepare_train_batch` on the same streams."""
    rng = np.random.RandomState(2)
    ramp = dict(kind='ladder', start_iters=[2, 4], values=[48, 56, 64])
    ours, theirs = _curricula(3), _curricula(3)
    ours.rescale_size_getter = tramps.get_ramp(**ramp)
    theirs.rescale_size_getter = jramps.get_ramp(**ramp)
    sizes = []
    for step in range(6):
        batch = {'image': rng.rand(2, 64, 64, 3).astype(np.float32),
                 'mask': (rng.rand(2, 64, 64, 1) > 0.5).astype(np.float32)}
        ours.global_step = theirs.global_step = step
        a = InpaintingTrainer.prepare_train_batch(ours, dict(batch))
        b = JaxTrainer._prepare_train_batch(theirs, dict(batch))
        for k in ('image', 'mask'):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f'{step} {k}')
        sizes.append(a['image'].shape[1:3])
    assert len(set(sizes)) > 1 and all(h % 16 == 0 for h, _ in sizes)


def test_trainer_streams_and_uint8_wire(tmp_path):
    """The trainer's crop streams are seeded as lama_tpu's (the shared one
    by `seed`, the per-host one by seed + 7919 x host); the uint8 wire is
    lama_tpu's and comes back as the loader's float values."""
    config = port_train.compose(port_train.CONFIG_DIR, 'big-lama', [
        'generator.ngf=8', 'generator.n_downsampling=2', 'generator.n_blocks=1',
        'discriminator.ndf=8', 'discriminator.n_layers=2', 'seed=11',
        'losses.resnet_pl.weight=0', 'trainer.kwargs.precision=32',
        'trainer.kwargs.input_transfer_dtype=uint8', 'evaluator.lpips=false',
        'evaluator.fid=false', 'evaluator.integral_kind=null',
        '+training_model.const_area_crop_kwargs.min_size=32'])
    trainer = InpaintingTrainer(config, str(tmp_path / 'run'), device='cpu')
    for ours, seed in ((trainer._shared_rng, 11), (trainer._host_rng, 11)):
        ref = np.random.RandomState(seed).get_state()
        assert all(np.array_equal(a, b) for a, b in zip(ours.get_state(), ref))
    rng = np.random.RandomState(0)
    batch = {'image': rng.randint(0, 256, (2, 8, 8, 3)).astype(np.float32) / 255,
             'mask': (rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32)}
    wire = trainer.to_wire(batch)
    theirs = JaxTrainer._to_wire(types.SimpleNamespace(
        input_transfer_dtype='uint8'), batch)
    for a, k in zip(wire, ('image', 'mask')):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, theirs[k])
    image, mask = trainer.to_device(wire)
    assert image.shape == (2, 3, 8, 8) and image.dtype == torch.float32
    np.testing.assert_array_equal(image.permute(0, 2, 3, 1).numpy(),
                                  batch['image'])
    np.testing.assert_array_equal(mask.permute(0, 2, 3, 1).numpy(),
                                  batch['mask'])


def _write_jpegs(root, n=4):
    os.makedirs(root)
    rng = np.random.RandomState(0)
    for i in range(n):
        cv2.imwrite(os.path.join(root, f'im{i}.jpg'),
                    (rng.rand(72, 80, 3) * 255).astype(np.uint8))


def test_steps_per_dispatch_2_trains_as_two_single_steps(tmp_path):
    _write_jpegs(str(tmp_path / 'data' / 'train'))
    tiny = ['generator.ngf=8', 'generator.n_downsampling=2',
            'generator.n_blocks=1', 'discriminator.ndf=8',
            'discriminator.n_layers=2', 'data.batch_size=2',
            'data.num_workers=1', 'data.train.out_size=64',
            'trainer.kwargs.precision=32', 'trainer.kwargs.limit_train_batches=2',
            'trainer.kwargs.log_every_n_steps=1', 'trainer.kwargs.max_epochs=1',
            'losses.resnet_pl.weight=0', 'device=cpu',
            f'location.data_root_dir={tmp_path / "data"}',
            f'location.out_root_dir={tmp_path}']
    runs = [port_train.main('big-lama', tiny + [
        f'run_dir={tmp_path / str(k)}', f'trainer.kwargs.steps_per_dispatch={k}',
        'trainer.kwargs.input_transfer_dtype=uint8'])
        for k in (1, 2)]
    assert runs[0].global_step == runs[1].global_step == 2
    ours, theirs = (r.state.state_dict()['state_dict'] for r in runs)
    for k, v in theirs.items():
        torch.testing.assert_close(ours[k], v, rtol=0, atol=0, msg=k)
    with pytest.raises(ValueError, match='multiple'):
        port_train.main('big-lama', tiny + [
            f'run_dir={tmp_path / "bad"}', 'trainer.kwargs.steps_per_dispatch=2',
            'trainer.kwargs.limit_train_batches=3'])
    with pytest.raises(ValueError, match='static batch shapes'):
        port_train.main('big-lama', tiny + [
            f'run_dir={tmp_path / "bad2"}', 'trainer.kwargs.steps_per_dispatch=2',
            '+training_model.const_area_crop_kwargs.min_size=32'])
