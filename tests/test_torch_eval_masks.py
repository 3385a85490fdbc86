"""The port's object-shaped mask synthesis against lama_tpu's on the CPU,
all exact: COUNTLESS, ObjectMask's algebra, the pseudo-panoptic ADE20k
predictor on fixed label maps, SegmentationMask and
RandomSegmentationMaskGenerator (and MixedMaskGenerator with segm_proba > 0)
with a stub segmenter, `python -m lama_tpu_torch.gen_mask_dataset` against
bin/gen_mask_dataset.py's files for both generator kinds, and the eval-set
visualisations. Where lama_tpu draws from the global np.random (seeded
np.random.seed(s) here), the port draws from np.random.RandomState(s). The
cases of tests/test_segm_backend.py come along: instances from a stub, the
refusals without (both) ADE20k weights, and the real segmenter on seeded
random weights when they are allowed.
"""
import glob
import os
import sys

import numpy as np
import PIL.Image as Image
import pytest
import torch
import yaml

from lama_tpu.data import masks as jdata_masks
from lama_tpu.evaluation import countless as jcountless
from lama_tpu.evaluation import masks as jmasks
from lama_tpu.evaluation import segm_backend as jbackend
from lama_tpu_torch.data import masks as data_masks
from lama_tpu_torch.evaluation import countless, masks, segm_backend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'bin'))

PLACEMENT = dict(max_object_area=0.5, min_mask_area=0.005, downsample_levels=5,
                 num_variants_per_mask=3, max_mask_intersection=0.9,
                 max_foreground_coverage=0.9, max_foreground_intersection=0.9,
                 max_hidden_area=0.5)


class StubSegmentationModule:
    """tests/test_segm_backend.py's: stuff background (wall, class 0) and
    two squares of a thing class (person, 12), plus a car (20) whose size
    follows the image's mean, so that images differ."""

    def predict(self, images, seg_size=None):
        b, h, w, _ = images.shape
        labels = np.zeros((b, h, w), np.int64)
        labels[:, h // 8: h // 3, w // 8: w // 3] = 12
        labels[:, h // 2: h // 2 + h // 4, w // 2: w // 2 + w // 4] = 12
        for i, img in enumerate(np.asarray(images)):
            side = int(h // 8 + img.mean() * h // 4)
            labels[i, h - side:, :side] = 20
        return labels, None


def predictors():
    return (segm_backend.ADE20kPanopticPredictor(
                segmentation_module=StubSegmentationModule()),
            jbackend.ADE20kPanopticPredictor(
                segmentation_module=StubSegmentationModule()))


def image(size=128, seed=0, chw=False):
    img = np.random.RandomState(seed).rand(size, size, 3).astype(np.float32)
    return img.transpose(2, 0, 1).copy() if chw else img


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16, np.int32, np.int64])
def test_countless_is_lama_tpus(dtype):
    rng = np.random.RandomState(1)
    data = rng.randint(0, 5, size=(16, 24)).astype(dtype)
    for fn in ('zero_corrected_countless', 'countless'):
        ours, theirs = (getattr(m, fn)(data) for m in (countless, jcountless))
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    cube = rng.randint(0, 4, size=(4, 6, 8)).astype(dtype)
    np.testing.assert_array_equal(countless.countless3d(cube),
                                  jcountless.countless3d(cube))


def test_object_mask_algebra_is_lama_tpus():
    rng = np.random.RandomState(2)
    blob = np.zeros((60, 80), bool)
    blob[12:40, 30:71] = rng.rand(28, 41) > 0.3
    for cls_ours, cls_theirs in ((masks.ObjectMask, jmasks.ObjectMask),):
        ours, theirs = cls_ours(blob), cls_theirs(blob)
        for op, kwargs in (('rescale', dict(scaling_factor=1.37)),
                           ('horizontal_flip', {}), ('vertical_flip', {}),
                           ('shift', dict(vertical=-20, horizontal=35)),
                           ('crop_to_canvas', {}), ('rescale', dict(scaling_factor=0.4)),
                           ('shift', dict(vertical=50, horizontal=-90))):
            ours = getattr(ours, op)(**kwargs)
            theirs = getattr(theirs, op)(**kwargs)
            assert (ours.up, ours.down, ours.left, ours.right) == \
                (theirs.up, theirs.down, theirs.left, theirs.right), op
            np.testing.assert_array_equal(ours.mask, theirs.mask)
            np.testing.assert_array_equal(ours.restore_full_mask(),
                                          theirs.restore_full_mask())
            assert ours.area() == theirs.area()


def test_panoptic_predictor_is_lama_tpus():
    """Fixed label maps (stuff, things in several components, pieces below
    min_instance_area) give the same panoptic map and segments; the class
    tables are lama_tpu's."""
    from lama_tpu.evaluation.segm_scores import get_segmentation_idx2name as jnames
    from lama_tpu_torch.evaluation.segm_scores import get_segmentation_idx2name
    assert segm_backend.ade20k_thing_class_ids() == \
        jbackend.ade20k_thing_class_ids()
    assert get_segmentation_idx2name() == jnames()
    things = sorted(segm_backend.ade20k_thing_class_ids())
    assert 12 in things and 0 not in things and 20 < len(things) < 150
    rng = np.random.RandomState(3)
    ours_pred, theirs_pred = predictors()
    for i in range(3):
        labels = rng.choice([0, 2, things[i], things[i + 5], 12], size=(12, 10))
        labels = np.kron(labels, np.ones((5, 6), np.int64))
        labels[0, 0] = things[9]           # a one-pixel instance: dropped
        ours = ours_pred.panoptic(labels)

        class Fixed:
            def predict(self, images, seg_size=None):
                return labels[None], None
        theirs = jbackend.ADE20kPanopticPredictor(segmentation_module=Fixed())(
            np.zeros((60, 60, 3), np.float32))
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]
        assert any(s['isthing'] for s in ours[1])


def test_backend_produces_instances():
    pred, _ = predictors()
    panoptic, info = pred(image())
    assert panoptic.shape == (128, 128)
    things = [s for s in info if s['isthing']]
    assert len(things) == 3 and len([s for s in info if not s['isthing']]) == 1
    for s in things:
        assert (panoptic == s['id']).any()


@pytest.mark.parametrize('kwargs', [
    dict(PLACEMENT),
    dict(PLACEMENT, rigidness_mode=0, position_shuffle=False,
         horizontal_flip=False),
    dict(PLACEMENT, max_mask_intersection=0.3, num_variants_per_mask=4),
])
def test_segmentation_mask_is_lama_tpus(kwargs):
    ours_pred, theirs_pred = predictors()
    ours = masks.SegmentationMask(predictor=ours_pred, **kwargs)
    theirs = jmasks.SegmentationMask(predictor=theirs_pred, **kwargs)
    total = 0
    for seed in range(3):
        img = image(seed=seed)
        np.random.seed(seed)
        want, want_pan = theirs.get_masks(img, return_panoptic=True)
        got, pan = ours.get_masks(img, return_panoptic=True,
                                  rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(pan, want_pan)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == (128, 128)
            np.testing.assert_array_equal(a, b)
            assert set(np.unique(a)) <= {0, 1}
        total += len(got)
    assert total > 3


def test_random_segmentation_mask_generator_is_lama_tpus():
    ours_pred, theirs_pred = predictors()
    ours = data_masks.RandomSegmentationMaskGenerator(predictor=ours_pred, **PLACEMENT)
    theirs = jdata_masks.RandomSegmentationMaskGenerator(predictor=theirs_pred,
                                                         **PLACEMENT)
    assert ours.impl is None          # built on the first call
    for seed in range(3):
        for args in ((image(seed=seed, chw=True),),       # CHW pixels
                     ((128, 128),)):                        # a shape + raw_image
            kwargs = {} if len(args[0]) == 3 else dict(raw_image=image(seed=seed))
            np.random.seed(seed)
            want = theirs(*args, **kwargs)
            got = ours(*args, rng=np.random.RandomState(seed), **kwargs)
            assert got.shape == (128, 128, 1) and got.dtype == np.float32
            assert got.max() == 1
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match='raw_image'):
        ours((128, 128), rng=np.random.RandomState(0))


def test_mixed_generator_with_segm_proba_is_lama_tpus():
    kwargs = dict(irregular_proba=1, box_proba=1, segm_proba=2,
                  invert_proba=0.3)
    ours_pred, theirs_pred = predictors()
    ours = data_masks.MixedMaskGenerator(
        segm_kwargs=dict(PLACEMENT, predictor=ours_pred), **kwargs)
    theirs = jdata_masks.MixedMaskGenerator(
        segm_kwargs=dict(PLACEMENT, predictor=theirs_pred), **kwargs)
    for seed in range(6):
        img = image(seed=seed, chw=True)
        np.random.seed(seed)
        want = theirs(img)
        np.testing.assert_array_equal(
            ours(img, rng=np.random.RandomState(seed)), want)


def test_default_backend_requires_real_weights(tmp_path):
    """Without resolvable ADE20k weights, or with only the encoder file, the
    default predictor refuses when it builds its segmenter (lama_tpu's
    policy); allow_random_weights runs the real segmenter on seeded random
    weights."""
    for weights_path in ('/nonexistent', str(tmp_path)):
        if weights_path == str(tmp_path):
            d = tmp_path / 'ade20k' / 'ade20k-resnet50dilated-ppm_deepsup'
            d.mkdir(parents=True)
            (d / 'encoder_epoch_20.pth').write_bytes(b'stub')
        for module in (segm_backend, jbackend):
            pred = module.ADE20kPanopticPredictor(weights_path=weights_path)
            with pytest.raises(RuntimeError, match='allow_random_weights'):
                _ = pred.module
    pred = segm_backend.ADE20kPanopticPredictor(
        weights_path=None, allow_random_weights=True, device='cpu',
        arch_encoder='mobilenetv2dilated')
    img = image(64)
    panoptic, info = pred(img)
    assert panoptic.shape == (64, 64) and isinstance(info, list)
    assert pred.module.device == torch.device('cpu')
    got = masks.SegmentationMask(predictor=pred, downsample_levels=5).get_masks(
        img, rng=np.random.RandomState(0))   # may be empty on random labels
    assert isinstance(got, list)


def write_jpgs(root, n=3):
    rng = np.random.RandomState(4)
    os.makedirs(os.path.join(root, 'sub'))
    for i in range(n):
        h, w = (100, 140) if i % 2 else (150, 96)
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(
            root, 'sub' if i == 2 else '', f'im{i}.jpg'))


def read_tree(root):
    return {os.path.relpath(p, root): np.array(Image.open(p))
            for p in sorted(glob.glob(os.path.join(root, '**', '*.png'),
                                      recursive=True))}


RANDOM_CONFIG = dict(
    generator_kind='random',
    mask_generator_kwargs=dict(
        irregular_proba=1, irregular_kwargs=dict(min_times=1, max_times=3,
                                                 max_width=20, max_len=40),
        box_proba=0.5, box_kwargs=dict(margin=0, bbox_min_size=5,
                                       bbox_max_size=30),
        segm_proba=0, variants_n=4),
    max_masks_per_image=2,
    cropping=dict(out_min_size=64, handle_small_mode='upscale',
                  out_square_crop=True, crop_min_overlap=1),
    max_tamper_area=0.5)


def test_gen_mask_dataset_random_is_bins(tmp_path):
    import gen_mask_dataset as bin_gen
    from lama_tpu_torch import gen_mask_dataset
    indir = str(tmp_path / 'in') + '/'
    write_jpgs(indir)
    config = tmp_path / 'random.yaml'
    config.write_text(yaml.safe_dump(RANDOM_CONFIG))
    files = sorted(glob.glob(os.path.join(indir, '**', '*.jpg'), recursive=True))
    bin_gen.process_images(files, indir, str(tmp_path / 'jax'), RANDOM_CONFIG,
                           seed=3)
    gen_mask_dataset.main(gen_mask_dataset.parse_args(
        [str(config), indir, str(tmp_path / 'port'), '--seed', '3',
         '--device', 'cpu']))
    ours, theirs = read_tree(tmp_path / 'port'), read_tree(tmp_path / 'jax')
    assert list(ours) == list(theirs) and len(ours) >= 6
    assert 'sub/im2_crop000_mask000.png' in ours
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    # --n-jobs 2: each chunk in its own process, seeded seed + its start
    gen_mask_dataset.main(gen_mask_dataset.parse_args(
        [str(config), indir, str(tmp_path / 'jobs'), '--seed', '3',
         '--n-jobs', '2', '--device', 'cpu']))
    for start, chunk in ((0, files[:2]), (2, files[2:])):
        gen_mask_dataset.process_images(chunk, indir, str(tmp_path / 'seq'),
                                        RANDOM_CONFIG, seed=3 + start,
                                        device='cpu')
    jobs, seq = read_tree(tmp_path / 'jobs'), read_tree(tmp_path / 'seq')
    assert list(jobs) == list(seq)
    for k in jobs:
        np.testing.assert_array_equal(jobs[k], seq[k])


def test_gen_mask_dataset_segmentation_is_bins(tmp_path, capsys, monkeypatch):
    import gen_mask_dataset as bin_gen
    from lama_tpu_torch import gen_mask_dataset
    indir = str(tmp_path / 'in') + '/'
    write_jpgs(indir)
    files = sorted(glob.glob(os.path.join(indir, '**', '*.jpg'), recursive=True))
    config = dict(generator_kind='segmentation',
                  mask_generator_kwargs=dict(PLACEMENT, downsample_levels=4),
                  max_masks_per_image=2,
                  cropping=dict(out_min_size=64, out_square_crop=True),
                  max_tamper_area=0.5)
    ours_pred, theirs_pred = predictors()
    np.random.seed(5)
    bin_gen.process_images(files, indir, str(tmp_path / 'jax'), dict(
        config, mask_generator_kwargs=dict(config['mask_generator_kwargs'],
                                           predictor=theirs_pred)), seed=5)
    gen_mask_dataset.process_images(files, indir, str(tmp_path / 'port'), dict(
        config, mask_generator_kwargs=dict(config['mask_generator_kwargs'],
                                           predictor=ours_pred)), seed=5,
        device='cpu')
    ours, theirs = read_tree(tmp_path / 'port'), read_tree(tmp_path / 'jax')
    assert list(ours) == list(theirs) and len(ours) >= 4
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])

    # without ADE20k weights: each image reports the refusal, no file is
    # written, as bin/gen_mask_dataset.py does
    monkeypatch.setenv('TORCH_HOME', str(tmp_path / 'no_weights'))
    path = tmp_path / 'segm.yaml'
    path.write_text(yaml.safe_dump(config))
    capsys.readouterr()
    gen_mask_dataset.main(gen_mask_dataset.parse_args(
        [str(path), indir, str(tmp_path / 'none'), '--device', 'cpu']))
    ours_out = capsys.readouterr().out
    bin_gen.main(bin_gen.argparse.Namespace(
        config=str(path), indir=indir, outdir=str(tmp_path / 'none_jax'),
        n_jobs=0, ext='jpg', seed=None))
    theirs_out = capsys.readouterr().out
    for out in (ours_out, theirs_out):
        assert out.count('Could not make masks') == len(files)
        assert 'allow_random_weights' in out
    assert read_tree(tmp_path / 'none') == read_tree(tmp_path / 'none_jax') == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device=cpu'):
            gen_mask_dataset.main(gen_mask_dataset.parse_args(
                [str(path), indir, str(tmp_path / 'cuda')]))


def test_eval_vis_is_lama_tpus(tmp_path):
    from lama_tpu.evaluation import vis as jvis
    from lama_tpu_torch.evaluation import vis
    rng = np.random.RandomState(6)
    mask = np.zeros((40, 48, 1), np.float32)
    mask[10:30, 5:20] = 1
    item = dict(image=rng.rand(40, 48, 3).astype(np.float32), mask=mask)
    for fn in ('save_item_for_vis', 'save_mask_for_sidebyside',
               'save_img_for_sidebyside', 'save_masked_img_for_sidebyside'):
        getattr(vis, fn)(item, str(tmp_path / f'{fn}.png'))
        getattr(jvis, fn)(item, str(tmp_path / f'{fn}_jax.png'))
        assert (tmp_path / f'{fn}.png').read_bytes() == \
            (tmp_path / f'{fn}_jax.png').read_bytes()
