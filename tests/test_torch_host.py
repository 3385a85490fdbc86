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
    with pytest.raises(NotImplementedError, match='online'):
        tdatasets.make_default_val_dataset(str(tmp_path), kind='online')
    with pytest.raises(ValueError):
        tdatasets.make_default_val_dataset(str(tmp_path), kind='nope')
