"""The port's serving path against bin/predict.py on the CPU.

One model dir (config.yaml + a reference-format .ckpt exported from a flax
generator) served by both CLIs on three tiny PNG pairs, one of odd size:
the written PNGs differ by at most one level, and known pixels are
bit-equal to the input. Also: refine=true serves like bin/predict.py, the
port's wires write the same files, out_key=predicted_image works, the port
imports neither jax nor lama_tpu (its int8 serving modules among them),
and the options of later slices raise.
"""
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lama_tpu.data.io import load_image, save_image
from lama_tpu_torch import predict as port_predict
from lama_tpu_torch.models import make_generator
from lama_tpu_torch.serving import (bucket_shape, load_serving_model,
                                    make_inpaint_forward)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_CFG = dict(
    kind='ffc_resnet', input_nc=4, output_nc=3, ngf=8, n_downsampling=2,
    n_blocks=2, add_out_act='sigmoid',
    init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75, enable_lfu=False),
)
SIZES = [(64, 64), (50, 70), (37, 45)]


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """Model dir + inputs, and both CLIs' fp32 outputs."""
    from lama_tpu.models import make_generator
    from lama_tpu.training.convert import flax_to_torch

    root = tmp_path_factory.mktemp('serve')
    model_dir = root / 'model'
    (model_dir / 'models').mkdir(parents=True)
    with open(model_dir / 'config.yaml', 'w') as f:
        yaml.safe_dump({'generator': GEN_CFG}, f)
    kw = dict(GEN_CFG)
    gen = make_generator(kw.pop('kind'), **kw)
    variables = gen.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 4)),
                         train=False)
    sd = {f'generator.{k}': torch.from_numpy(np.ascontiguousarray(v))
          for k, v in flax_to_torch(variables, model=gen).items()}
    for k in [k for k in sd if k.endswith('.running_mean')]:
        sd[k[:-len('running_mean')] + 'num_batches_tracked'] = torch.zeros(
            (), dtype=torch.long)
    torch.save({'state_dict': sd}, model_dir / 'models' / 'best.ckpt')

    rng = np.random.RandomState(0)
    indir = root / 'in'
    indir.mkdir()
    for i, (h, w) in enumerate(SIZES):
        mask = np.zeros((h, w, 1))
        mask[h // 4: h // 2 + 3, w // 5: w // 2] = 1.0
        save_image(str(indir / f'img{i}.png'), rng.rand(h, w, 3))
        save_image(str(indir / f'img{i}_mask.png'), mask)

    spec = importlib.util.spec_from_file_location(
        'bin_predict_port_test', os.path.join(REPO, 'bin', 'predict.py'))
    jax_predict = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_predict)
    common = [f'model.path={model_dir}', f'indir={indir}', 'device=cpu',
              'precision=fp32']
    jax_predict.main(common + [f'outdir={root / "jax"}'])
    port_predict.main(common + [f'outdir={root / "port"}', 'batch_size=2'])
    return root, common


def _read(root, sub, i):
    return load_image(str(root / sub / f'img{i}_mask.png'), return_orig=True)[1]


def test_port_predict_matches_bin_predict(served):
    root, _ = served
    for i, (h, w) in enumerate(SIZES):
        ours, theirs = _read(root, 'port', i), _read(root, 'jax', i)
        assert ours.shape == (h, w, 3)
        diff = np.abs(ours.astype(int) - theirs.astype(int))
        assert diff.max() <= 1, (i, diff.max())
        img = load_image(str(root / 'in' / f'img{i}.png'), return_orig=True)[1]
        mask = load_image(str(root / 'in' / f'img{i}_mask.png'),
                          mode='L', return_orig=True)[1][..., 0]
        known = mask == 0
        np.testing.assert_array_equal(ours[known], img[known])
        assert np.abs(ours[~known].astype(int) - img[~known]).max() > 0


def test_wire_uint8_writes_the_same_files(served):
    root, common = served
    port_predict.main(common + [f'outdir={root / "port_u8"}', 'batch_size=2',
                                'wire=uint8'])
    for i in range(len(SIZES)):
        np.testing.assert_array_equal(_read(root, 'port_u8', i),
                                      _read(root, 'port', i))


def test_out_key_predicted_image(served):
    root, common = served
    port_predict.main(common + [f'outdir={root / "port_pred"}',
                                'out_key=predicted_image'])
    for i, (h, w) in enumerate(SIZES):
        pred, inp = _read(root, 'port_pred', i), _read(root, 'port', i)
        mask = load_image(str(root / 'in' / f'img{i}_mask.png'),
                          mode='L', return_orig=True)[1][..., 0]
        assert pred.shape == (h, w, 3)
        np.testing.assert_array_equal(pred[mask > 0], inp[mask > 0])
        assert (pred[mask == 0] != inp[mask == 0]).any()


def test_bucket_shape_matches_jax():
    from lama_tpu.serving import bucket_shape as jax_bucket_shape
    for hw in [(37, 45), (64, 64), (500, 380), (512, 512), (1, 1)]:
        for modulo, bucket in [(8, 64), (8, 8), (0, 16)]:
            assert (bucket_shape(*hw, modulo, bucket)
                    == jax_bucket_shape(*hw, modulo, bucket))


def test_refine_serves_like_bin_predict(served):
    """refine=true through both CLIs, two pyramid scales for the 64^2 and
    50x70 images (min_side 32) and 2 Adam steps: PNGs within one level,
    known pixels bit-equal to the input."""
    root, common = served
    refine = ['refine=true', 'refiner.min_side=32', 'refiner.n_iters=3']
    spec = importlib.util.spec_from_file_location(
        'bin_predict_refine_test', os.path.join(REPO, 'bin', 'predict.py'))
    jax_predict = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_predict)
    jax_predict.main(common + refine + [f'outdir={root / "jax_refine"}'])
    port_predict.main(common + refine + [f'outdir={root / "port_refine"}',
                                         'batch_size=4'])
    for i, (h, w) in enumerate(SIZES):
        ours, theirs = _read(root, 'port_refine', i), _read(root, 'jax_refine', i)
        assert ours.shape == theirs.shape == (h, w, 3)
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1
        img = load_image(str(root / 'in' / f'img{i}.png'), return_orig=True)[1]
        mask = load_image(str(root / 'in' / f'img{i}_mask.png'),
                          mode='L', return_orig=True)[1][..., 0]
        np.testing.assert_array_equal(ours[mask == 0], img[mask == 0])


def test_refine_with_int8_is_refused(served):
    root, common = served
    with pytest.raises(ValueError, match='int8'):
        port_predict.main(common + [f'outdir={root / "never"}', 'refine=true',
                                    'precision=int8'])


def test_port_imports_no_jax():
    code = ('import sys; import lama_tpu_torch, lama_tpu_torch.serving, '
            'lama_tpu_torch.predict; '
            'print(any(m == "jax" or m.startswith(("jax.", "flax")) '
            'for m in sys.modules))')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == 'False'


def test_port_and_chip_smoke_import_nothing_of_lama_tpu():
    """The port (its serving, refining, training and evaluation entry points
    and modules, the data-parallel modules, the device CLIs and the op
    registrations) and
    chip_smoke.py load no module of lama_tpu, jax or flax,
    also while chip_smoke.py reads the big-lama config and an evaluator is
    built."""
    code = ('import sys; import lama_tpu_torch, lama_tpu_torch.serving, '
            'lama_tpu_torch.predict, lama_tpu_torch.evaluation.refinement, '
            'lama_tpu_torch.train, lama_tpu_torch.training.trainer, '
            'lama_tpu_torch.training.step, lama_tpu_torch.training.state, '
            'lama_tpu_torch.training.checkpoint, '
            'lama_tpu_torch.training.visualizers, '
            'lama_tpu_torch.losses.perceptual, lama_tpu_torch.losses.adversarial, '
            'lama_tpu_torch.losses.feature_matching, '
            'lama_tpu_torch.models.pix2pixhd, lama_tpu_torch.models.aux.resnet, '
            'lama_tpu_torch.models.pix2pixhd_extra, '
            'lama_tpu_torch.models.multiscale, '
            'lama_tpu_torch.data.masks, lama_tpu_torch.data.transforms, '
            'lama_tpu_torch.utils.ramps, lama_tpu_torch.ops.kernels.halo_conv, '
            'lama_tpu_torch.evaluation, lama_tpu_torch.evaluate_predicts, '
            'lama_tpu_torch.fid_score, lama_tpu_torch.evaluation.scores, '
            'lama_tpu_torch.evaluation.evaluator, '
            'lama_tpu_torch.evaluation.utils, '
            'lama_tpu_torch.models.aux.inception, '
            'lama_tpu_torch.models.aux.small_nets, '
            'lama_tpu_torch.models.aux.segmentation, '
            'lama_tpu_torch.models.aux.mobilenet, '
            'lama_tpu_torch.evaluation.segm_scores, '
            'lama_tpu_torch.evaluation.segm_backend, '
            'lama_tpu_torch.evaluation.masks, '
            'lama_tpu_torch.evaluation.countless, '
            'lama_tpu_torch.evaluation.lpips_research, '
            'lama_tpu_torch.evaluation.vis, '
            'lama_tpu_torch.losses.segmentation, '
            'lama_tpu_torch.gen_mask_dataset, '
            'lama_tpu_torch.losses.style, '
            'lama_tpu_torch.losses.distance_weighting, '
            'lama_tpu_torch.models.fake_fakes, lama_tpu_torch.ops.geometry, '
            'lama_tpu_torch.models.ffc, lama_tpu_torch.data.datasets, '
            'lama_tpu_torch.ops.quant, lama_tpu_torch.ops.serving_mode, '
            'lama_tpu_torch.ops.kernels.conv_int8, lama_tpu_torch.convert, '
            'lama_tpu_torch.tools.conv_int8_time, '
            'lama_tpu_torch.ops.kernels.library, lama_tpu_torch.export, '
            'lama_tpu_torch.make_checkpoint, '
            'lama_tpu_torch.predict_inner_features, '
            'lama_tpu_torch.precompile, lama_tpu_torch.evaluator_example, '
            'lama_tpu_torch.analyze_errors, '
            'lama_tpu_torch.evaluation.linear_svm, '
            'lama_tpu_torch.verify_reference_parity, '
            'lama_tpu_torch.parallel.multihost, '
            'lama_tpu_torch.parallel.data_parallel, '
            'chip_smoke; chip_smoke.big_lama_kwargs(); '
            'lama_tpu_torch.losses.distance_weighting.'
            'make_mask_distance_weighter("pps"); '
            'lama_tpu_torch.losses.perceptual.VGG19PerceptualLoss(); '
            'lama_tpu_torch.losses.style.StylePerceptualLoss(); '
            'lama_tpu_torch.models.make_discriminator("ffc_nlayer"); '
            'lama_tpu_torch.evaluation.make_evaluator(device="cpu"); '
            'lama_tpu_torch.models.aux.segmentation.SegmentationModule('
            'arch_encoder="mobilenetv2dilated", device="cpu"); '
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("lama_tpu", "jax", "flax", "jaxlib")))')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == '[]'


def test_train_cli_options_import_nothing_of_lama_tpu(tmp_path):
    """`python -m lama_tpu_torch.train` (run as -m runs it, tiny, on the
    CPU) with the options of lama_tpu's trainer that ROADMAP queue 1 item
    10 ported (the FFC discriminator, bce, the VGG19 loss, pps, fake
    fakes, input noise, the curricula, the uint8 wire, web shards, online
    validation) loads no module of lama_tpu, jax or flax."""
    import tarfile
    from PIL import Image
    (tmp_path / 'img').mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray((rng.rand(72, 80, 3) * 255).astype(np.uint8)).save(
            tmp_path / 'img' / f'{i}.jpg')
    with tarfile.open(str(tmp_path / 'shard.tar'), 'w') as tf:
        tf.add(str(tmp_path / 'img'), arcname='img')
    argv = ['-cn', 'big-lama', f'run_dir={tmp_path / "run"}',
            f'location.out_root_dir={tmp_path}', 'generator.ngf=8',
            'generator.n_downsampling=2', 'generator.n_blocks=1',
            'generator.input_nc=7', 'discriminator.kind=ffc_nlayer',
            'discriminator.ndf=8', 'discriminator.n_layers=2',
            'data.batch_size=2', 'data.num_workers=1',
            'data.train.out_size=64', 'data.train.kind=default_web',
            f'data.train.indir={tmp_path / "shard.tar"}',
            f'data.val.indir={tmp_path / "img"}', 'data.val.kind=online',
            '+data.val.mask_gen_kwargs.segm_proba=0',
            'data.val.img_suffix=.jpg', 'evaluator.lpips=false',
            'evaluator.fid=false', 'evaluator.integral_kind=null',
            'trainer.kwargs.precision=32', 'trainer.kwargs.max_epochs=1',
            'trainer.kwargs.limit_train_batches=1',
            'trainer.kwargs.input_transfer_dtype=uint8',
            'losses.resnet_pl.weight=0', 'losses.perceptual.weight=0.03',
            'losses.adversarial.kind=bce', '~losses.adversarial.gp_coef',
            '~losses.adversarial.mask_as_fake_target',
            '+training_model.fake_fakes_proba=1.0',
            '+training_model.distance_weighter_kwargs.kind=pps',
            '+training_model.add_noise_kwargs.scales=3',
            '+training_model.rescale_scheduler_kwargs.kind=ladder',
            '+training_model.rescale_scheduler_kwargs.start_iters=[5]',
            '+training_model.rescale_scheduler_kwargs.values=[64,64]',
            '+training_model.const_area_crop_kwargs.min_size=48',
            '+training_model.const_area_crop_kwargs.max_size=64',
            '+training_model.const_area_crop_kwargs.area=3072',
            'device=cpu']
    code = ('import runpy, sys; sys.argv = ["train"] + ' + repr(argv) + '; '
            'runpy.run_module("lama_tpu_torch.train", run_name="__main__"); '
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("lama_tpu", "jax", "flax", "jaxlib")))')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == '[]'
    assert (tmp_path / 'run' / 'models' / 'last.ckpt').exists()


def test_gen_mask_dataset_cli_imports_nothing_of_lama_tpu(tmp_path):
    """`python -m lama_tpu_torch.gen_mask_dataset` (run as -m runs it, on
    a tiny image with a random-kind config) loads no module of lama_tpu,
    jax or flax and writes its pair."""
    import yaml
    from PIL import Image
    (tmp_path / 'in').mkdir()
    Image.fromarray(np.full((40, 56, 3), 128, np.uint8)).save(
        tmp_path / 'in' / 'a.jpg')
    config = tmp_path / 'gen.yaml'
    config.write_text(yaml.safe_dump(dict(
        generator_kind='random', cropping=dict(out_min_size=32),
        mask_generator_kwargs=dict(irregular_proba=1, box_proba=0,
                                   segm_proba=0, variants_n=1))))
    code = ('import runpy, sys; sys.argv = ["gen_mask_dataset", '
            f'"{config}", "{tmp_path / "in"}", "{tmp_path / "out"}", '
            '"--seed", "0", "--device", "cpu"]; '
            'runpy.run_module("lama_tpu_torch.gen_mask_dataset", '
            'run_name="__main__"); '
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("lama_tpu", "jax", "flax", "jaxlib")))')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == '[]'
    assert sorted(os.listdir(tmp_path / 'out')) == ['a_crop000.png',
                                                    'a_crop000_mask000.png']


@pytest.mark.parametrize('override', ['precision=int8',
                                      'spatial_shards=2',
                                      'quant_calibration=4',
                                      'spectral_bf16_store=true'])
def test_later_options_raise(served, override):
    """spatial_shards is a later slice's and raises NotImplementedError.
    The serving options of int8 serving are ported: on this fp32 serve
    they raise as bin/predict.py does (quant_calibration without int8,
    spectral_bf16_store with fp32), and precision=int8 serves, known
    pixels kept."""
    root, common = served
    argv = common + [f'outdir={root / "never"}', override]
    if override == 'precision=int8':
        port_predict.main(common[:-1] + [f'outdir={root / "int8"}', override])
        for i in range(len(SIZES)):
            img = load_image(str(root / 'in' / f'img{i}.png'),
                             return_orig=True)[1]
            mask = load_image(str(root / 'in' / f'img{i}_mask.png'),
                              mode='L', return_orig=True)[1][..., 0]
            out = _read(root, 'int8', i)
            np.testing.assert_array_equal(out[mask == 0], img[mask == 0])
        return
    if override == 'spatial_shards=2':
        with pytest.raises(NotImplementedError):
            port_predict.main(argv)
        return
    with pytest.raises(ValueError, match=override.split('=')[0]):
        port_predict.main(argv)


def test_cuda_device_without_a_card_raises(served):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    root, common = served
    argv = [a for a in common if not a.startswith('device=')]
    with pytest.raises(RuntimeError, match='device=cpu'):
        port_predict.main(argv + [f'outdir={root / "never"}'])


def test_model_enable_lfu_raises(tmp_path):
    """A model dir whose generator has LFU (refused until LFU was ported)
    loads its checkpoint strictly, `lfu` weights included, and serves."""
    cfg = dict(GEN_CFG, resnet_conv_kwargs=dict(ratio_gin=0.75,
                                                ratio_gout=0.75,
                                                enable_lfu=True))
    (tmp_path / 'models').mkdir()
    with open(tmp_path / 'config.yaml', 'w') as f:
        yaml.safe_dump({'generator': cfg}, f)
    kw = dict(cfg)
    sd = make_generator(kw.pop('kind'), **kw).state_dict()
    assert any('.lfu.' in k for k in sd)
    torch.save({'state_dict': {f'generator.{k}': v for k, v in sd.items()}},
               tmp_path / 'models' / 'best.ckpt')
    gen, _ = load_serving_model(str(tmp_path), precision='fp32', device='cpu')
    forward = make_inpaint_forward(gen)
    image, mask = torch.rand(1, 32, 32, 3), torch.zeros(1, 32, 32, 1)
    mask[:, 8:20, 8:24] = 1
    out = forward(image, mask)
    assert out.shape == (1, 32, 32, 3)
    assert torch.equal(out[mask[..., 0] == 0], image[mask[..., 0] == 0])
