"""The port's copies of lama_tpu's host modules give lama_tpu's answers.

lama_tpu_torch.config (compose, load_yaml, resolve_interpolations, to_dict),
lama_tpu_torch.data.io and lama_tpu_torch.data.datasets (kinds default and
our_eval) against lama_tpu.config, lama_tpu.data.io and
lama_tpu.data.datasets on the same files: equal results, exactly.
"""
import os

import numpy as np
import pytest
import torch

from lama_tpu import config as jconfig
from lama_tpu.data import datasets as jdatasets
from lama_tpu.data import io as jio
from lama_tpu_torch import config as tconfig
from lama_tpu_torch.data import datasets as tdatasets
from lama_tpu_torch.data import io as tio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('overrides', [
    [],
    ['refine=true', 'refiner.n_iters=3', 'dataset.pad_out_to_modulo=16',
     'device=cpu', '+extra.list=[1,2]', '~pipeline_depth'],
])
def test_compose_matches_jax(overrides):
    config_dir = os.path.join(REPO, 'configs', 'prediction')
    ours = tconfig.compose(config_dir, 'default', overrides)
    theirs = jconfig.compose(config_dir, 'default', overrides)
    assert tconfig.to_dict(ours) == jconfig.to_dict(theirs)
    if overrides:   # the refiner's modulo follows the dataset's
        assert ours.refiner.modulo == 16 and ours.refiner.n_iters == 3


def test_load_yaml_matches_jax():
    from lama_tpu.config.node import resolve_interpolations
    path = os.path.join(REPO, 'configs', 'training', 'big-lama.yaml')
    ours = tconfig.resolve_interpolations(tconfig.load_yaml(path))
    theirs = resolve_interpolations(jconfig.load_yaml(path))
    assert tconfig.to_dict(ours) == jconfig.to_dict(theirs)
    assert ours.generator.kind == 'ffc_resnet'


def test_io_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.rand(13, 22, 3).astype(np.float32)
    tio.save_image(str(tmp_path / 'ours' / 'a.png'), img)
    jio.save_image(str(tmp_path / 'theirs' / 'a.png'), img)
    for mode in ('RGB', 'L'):
        a, a8 = tio.load_image(str(tmp_path / 'ours' / 'a.png'), mode=mode,
                               return_orig=True)
        b, b8 = jio.load_image(str(tmp_path / 'theirs' / 'a.png'), mode=mode,
                               return_orig=True)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a8, b8)
    for x, mod in ((13, 8), (16, 8), (1, 3)):
        assert tio.ceil_modulo(x, mod) == jio.ceil_modulo(x, mod)
    np.testing.assert_array_equal(tio.pad_img_to_modulo(img, 8),
                                  jio.pad_img_to_modulo(img, 8))
    np.testing.assert_array_equal(tio.scale_image(img, 0.5),
                                  jio.scale_image(img, 0.5))
    np.testing.assert_array_equal(tio.scale_image(img[..., :1], 2.0),
                                  jio.scale_image(img[..., :1], 2.0))


def _write_pairs(root, layout):
    rng = np.random.RandomState(1)
    for i, (h, w) in enumerate([(20, 30), (17, 9)]):
        img = rng.rand(h, w, 3)
        mask = (rng.rand(h, w, 1) > 0.5).astype(np.float64)
        if layout == 'default':
            jio.save_image(str(root / 'sub' / f'im{i}.png'), img)
            jio.save_image(str(root / 'sub' / f'im{i}_mask000.png'), mask)
        else:
            jio.save_image(str(root / 'img' / f'im{i}.png'), img)
            jio.save_image(str(root / 'mask' / f'im{i}_crop-mask000.png'),
                           mask)


@pytest.mark.parametrize('kind', ['default', 'our_eval'])
def test_datasets_match_jax(tmp_path, kind):
    _write_pairs(tmp_path, kind)
    kw = dict(kind=kind, img_suffix='.png', pad_out_to_modulo=8)
    ours = tdatasets.make_default_val_dataset(str(tmp_path) + '/', **kw)
    theirs = jdatasets.make_default_val_dataset(str(tmp_path) + '/', **kw)
    assert len(ours) == len(theirs) == 2
    assert ours.mask_filenames == theirs.mask_filenames
    assert ours.img_filenames == theirs.img_filenames
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dataset_kind_online_raises(tmp_path):
    """The `online` kind (ROADMAP queue 1 item 10) builds, as lama_tpu's
    (its items: tests/test_torch_host_train.py); an unknown kind raises."""
    ours = tdatasets.make_default_val_dataset(str(tmp_path), kind='online')
    theirs = jdatasets.make_default_val_dataset(str(tmp_path), kind='online')
    assert type(ours).__name__ == type(theirs).__name__
    assert len(ours) == len(theirs) == 0
    with pytest.raises(ValueError):
        tdatasets.make_default_val_dataset(str(tmp_path), kind='nope')


# ------------------------------------------------------------ training data
from lama_tpu.data import masks as jmasks          # noqa: E402
from lama_tpu.data import transforms as jtransforms  # noqa: E402
from lama_tpu.utils import ramps as jramps          # noqa: E402
from lama_tpu_torch.data import masks as tmasks     # noqa: E402
from lama_tpu_torch.data import transforms as ttransforms  # noqa: E402
from lama_tpu_torch.utils import ramps as tramps    # noqa: E402

BIG_LAMA_MASKS = dict(   # configs/training/data/abl-04-256-mh-dist.yaml
    irregular_proba=1, irregular_kwargs=dict(
        max_angle=4, max_len=200, max_width=100, max_times=5, min_times=1),
    box_proba=1, box_kwargs=dict(margin=10, bbox_min_size=30,
                                 bbox_max_size=150, max_times=4, min_times=1),
    segm_proba=0)


@pytest.mark.parametrize('kind,kwargs', [
    ('mixed', BIG_LAMA_MASKS),
    ('mixed', dict(irregular_proba=1, irregular_kwargs=dict(
        ramp_kwargs=dict(start_iter=0, end_iter=10)), box_proba=0,
        segm_proba=0, squares_proba=1, superres_proba=1, outpainting_proba=1,
        invert_proba=0.5)),
    ('outpainting', dict()),
    ('dumb', dict(is_training=True)),
])
def test_mask_generators_match_jax(kind, kwargs):
    ours = tmasks.get_mask_generator(kind, dict(kwargs))
    theirs = jmasks.get_mask_generator(kind, dict(kwargs))
    for i in range(12):
        a = ours((256, 200), iter_i=i, rng=np.random.RandomState(i))
        b = theirs((256, 200), iter_i=i, rng=np.random.RandomState(i))
        np.testing.assert_array_equal(a, b)
    # segm_proba > 0 builds its segmenter on the first call, not here
    segm = tmasks.get_mask_generator('mixed', dict(segm_proba=1))
    assert isinstance(segm.gens[-1], tmasks.RandomSegmentationMaskGenerator)
    assert segm.gens[-1].impl is None


@pytest.mark.parametrize('variant', ['default', 'distortions',
                                     'distortions_light', 'no_augs'])
def test_transforms_match_jax(variant):
    rng = np.random.RandomState(2)
    img = (rng.rand(90, 110, 3) * 255).astype(np.uint8)
    ours = ttransforms.get_transforms(variant, 64)
    theirs = jtransforms.get_transforms(variant, 64)
    for i in range(8):
        np.testing.assert_array_equal(
            ours(image=img, rng=np.random.RandomState(i))['image'],
            theirs(image=img, rng=np.random.RandomState(i))['image'])


def test_ramps_match_jax():
    for kw in (dict(kind='linear', start_value=1, end_value=3, start_iter=2,
                    end_iter=10),
               dict(kind='ladder', start_iters=[3, 7], values=[1, 2, 4])):
        ours, theirs = tramps.get_ramp(**dict(kw)), jramps.get_ramp(**dict(kw))
        assert [ours(i) for i in range(12)] == [theirs(i) for i in range(12)]


def _write_train_jpegs(root, n):
    import cv2
    os.makedirs(root)
    rng = np.random.RandomState(3)
    for i in range(n):
        img = (rng.rand(70 + 3 * i, 90, 3) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(root, f'im{i}.jpg'), img)


@pytest.mark.parametrize('num_workers', [1, 3])
def test_train_loader_batches_match_jax(tmp_path, num_workers):
    """make_default_train_dataloader with big-lama's masks and transforms:
    the same batches, bit for bit, over two epochs (the JAX dataset decodes
    with its native libjpeg where built, the port with cv2)."""
    _write_train_jpegs(str(tmp_path / 'train'), 7)
    kw = dict(indir=str(tmp_path / 'train'), out_size=64,
              mask_gen_kwargs=BIG_LAMA_MASKS, transform_variant='distortions',
              seed=5, dataloader_kwargs=dict(batch_size=3, shuffle=True,
                                             num_workers=num_workers, seed=5))
    ours = tdatasets.make_default_train_dataloader(**kw)
    theirs = jdatasets.make_default_train_dataloader(**kw)
    assert len(ours) == len(theirs) == 2
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        pairs = list(zip(ours, theirs))
        assert len(pairs) == 2
        for a, b in pairs:
            assert sorted(a) == sorted(b) == ['image', 'mask']
            for k in a:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the web-shard kind (ROADMAP queue 1 item 10) takes tar shards (its
    # batches: tests/test_torch_host_train.py)
    with pytest.raises(ValueError, match='shard'):
        tdatasets.make_default_train_dataloader(
            **dict(kw, kind='default_web', indir=str(tmp_path / 'none*.tar')))


def test_save_config_matches_jax(tmp_path):
    config_dir = os.path.join(REPO, 'configs', 'training')
    overrides = ['location.data_root_dir=/d', 'data.batch_size=10']
    tconfig.save_config(tconfig.compose(config_dir, 'big-lama', overrides),
                        str(tmp_path / 'ours.yaml'))
    jconfig.save_config(jconfig.compose(config_dir, 'big-lama', overrides),
                        str(tmp_path / 'theirs.yaml'))
    assert (tmp_path / 'ours.yaml').read_text() == \
        (tmp_path / 'theirs.yaml').read_text()
