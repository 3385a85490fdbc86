"""`python -m lama_tpu_torch.train` on the CPU at a tiny size.

big-lama's config (configs/training/big-lama.yaml) cut to ngf 8, 2
downsamplings, 2 blocks, ndf 8, n_layers 2, batch 2, 64^2 crops, fp32,
ResNetPL with random weights, one batch per epoch, on synthetic JPEGs:
- `python -m lama_tpu_torch.train` for two epochs (2 steps) writes
  <run_dir>/config.yaml, metrics.jsonl, sample grids and models/last.ckpt,
  which `python -m lama_tpu_torch.predict` serves (known pixels kept);
- resumed from that checkpoint for a third epoch, the run ends where an
  unbroken 3-epoch run ends: weights, BN statistics, optimizer states and
  the step counter equal;
- the options that belong to later items raise; those of ROADMAP queue 1
  item 10 (steps_per_dispatch, the uint8 wire, the rescale ramp, fake
  fakes, web shards, `online` validation data) train one epoch;
  validation itself is held by tests/test_torch_train_val.py.
"""
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

from lama_tpu_torch import predict as port_predict
from lama_tpu_torch import train as port_train
from lama_tpu_torch.data.io import load_image, save_image

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ['generator.ngf=8', 'generator.n_downsampling=2',
        'generator.n_blocks=2', 'discriminator.ndf=8',
        'discriminator.n_layers=2', 'data.batch_size=2', 'data.num_workers=1',
        'data.train.out_size=64', 'trainer.kwargs.precision=32',
        'trainer.kwargs.limit_train_batches=1',
        'trainer.kwargs.log_every_n_steps=1',
        'losses.resnet_pl.allow_random_weights=true', 'device=cpu']


def _write_jpegs(root, n=4):
    import cv2
    os.makedirs(root)
    rng = np.random.RandomState(0)
    for i in range(n):
        h, w = 72 + 4 * i, 80
        yy, xx = np.mgrid[0:h, 0:w] / 11.0
        img = np.stack([np.sin(yy + i), np.cos(xx), np.sin(xx + yy)], -1)
        img = np.clip(0.5 + 0.4 * img + 0.05 * rng.randn(h, w, 3), 0, 1)
        cv2.imwrite(os.path.join(root, f'im{i}.jpg'),
                    np.rint(img * 255).astype(np.uint8))


def _train(root, run, epochs, *extra):
    return port_train.main('big-lama', [
        f'location.data_root_dir={root / "data"}',
        f'location.out_root_dir={root}', f'run_dir={root / run}',
        f'trainer.kwargs.max_epochs={epochs}', *TINY, *extra])


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The two-step run through `python -m lama_tpu_torch.train` (a process
    of its own); the resumed and the unbroken run in this process."""
    root = tmp_path_factory.mktemp('train')
    _write_jpegs(str(root / 'data' / 'train'))
    res = subprocess.run(
        [sys.executable, '-m', 'lama_tpu_torch.train', '-cn', 'big-lama',
         f'location.data_root_dir={root / "data"}',
         f'location.out_root_dir={root}', f'run_dir={root / "two"}',
         'trainer.kwargs.max_epochs=2', *TINY],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        # one CPU thread, as in this process: the resumed run continues it
        # and is held bit-equal to an unbroken run here
        env=dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1'))
    assert res.returncode == 0, res.stderr[-3000:]
    ckpt = root / 'two' / 'models' / 'last.ckpt'
    saved = torch.load(ckpt, map_location='cpu', weights_only=False)
    resumed = _train(root, 'resumed', 3,
                     f'trainer.resume_from_checkpoint={ckpt}')
    unbroken = _train(root, 'unbroken', 3)
    return root, saved, resumed, unbroken


def test_two_steps_write_a_run_dir_that_predict_serves(runs):
    root, saved, _, _ = runs
    run = root / 'two'
    assert saved['global_step'] == 2
    assert saved['epoch'] == 1
    assert any(k.startswith('discriminator.') for k in saved['state_dict'])
    assert len(saved['optimizer_states']) == 2
    lines = [json.loads(ln) for ln in open(run / 'metrics.jsonl')]
    assert [ln['step'] for ln in lines] == [0, 1]
    assert all(np.isfinite(ln['gen_total']) for ln in lines)
    assert (run / 'samples' / 'epoch0000_train' / 'batch0000000.jpg').exists()
    indir = root / 'serve_in'
    img = np.random.RandomState(1).rand(64, 64, 3)
    mask = np.zeros((64, 64, 1))
    mask[10:30, 20:44] = 1
    save_image(str(indir / 'a.png'), img)
    save_image(str(indir / 'a_mask.png'), mask)
    port_predict.main([f'model.path={run}', 'model.checkpoint=last.ckpt',
                       f'indir={indir}', f'outdir={root / "served"}',
                       'device=cpu', 'precision=fp32'])
    out = load_image(str(root / 'served' / 'a_mask.png'), return_orig=True)[1]
    orig = load_image(str(indir / 'a.png'), return_orig=True)[1]
    assert out.shape == (64, 64, 3)
    known = mask[..., 0] == 0
    np.testing.assert_array_equal(out[known], orig[known])


def test_resume_matches_an_unbroken_run(runs):
    _, _, resumed, unbroken = runs
    assert resumed.global_step == unbroken.global_step == 3
    ours, theirs = resumed.state.state_dict(), unbroken.state.state_dict()
    assert ours['state_dict'].keys() == theirs['state_dict'].keys()
    for k, v in theirs['state_dict'].items():
        torch.testing.assert_close(ours['state_dict'][k], v, rtol=0, atol=0,
                                   msg=k)
    for a, b in zip(ours['optimizer_states'], theirs['optimizer_states']):
        for pid, st in b['state'].items():
            for key, v in st.items():
                torch.testing.assert_close(a['state'][pid][key], v, rtol=0,
                                           atol=0)


# the options of lama_tpu's trainer: those ported (ROADMAP queue 1 item 10,
# LFU and the multidilated discriminator) train (with the keys each needs
# beside the one named); the others raise
PORTED = {
    'trainer.kwargs.steps_per_dispatch=2': [
        'trainer.kwargs.limit_train_batches=2'],
    'trainer.kwargs.input_transfer_dtype=uint8': [],
    '+training_model.rescale_scheduler_kwargs.kind=ladder': [
        '+training_model.rescale_scheduler_kwargs.start_iters=[1]',
        '+training_model.rescale_scheduler_kwargs.values=[64,80]'],
    '+training_model.fake_fakes_proba=0.5': [],
    'data.train.kind=default_web': ['data.train.indir={root}/shard.tar'],
    'generator.resnet_conv_kwargs.enable_lfu=true': [],
    # its [2, 3] padding names two branches
    'discriminator.kind=pix2pixhd_nlayer_multidilated': [
        '+discriminator.multidilation_kwargs.dilation_num=2'],
}


@pytest.mark.parametrize('override', [
    'trainer.kwargs.steps_per_dispatch=2',
    'trainer.kwargs.input_transfer_dtype=uint8',
    'trainer.kwargs.devices=2',
    '+training_model.rescale_scheduler_kwargs.kind=ladder',
    '+training_model.fake_fakes_proba=0.5',
    'data.train.kind=default_web',
    'generator.resnet_conv_kwargs.enable_lfu=true',
    'discriminator.kind=pix2pixhd_nlayer_multidilated',
])
def test_options_of_later_items_raise(tmp_path, override):
    """More than one device (item 11) raises; the options item 10 ported,
    LFU and the multidilated discriminator train one epoch (one step; two
    for steps_per_dispatch) with finite losses."""
    _write_jpegs(str(tmp_path / 'data' / 'train'))
    if override not in PORTED:
        with pytest.raises(NotImplementedError):
            _train(tmp_path, 'never', 1, override)
        return
    with tarfile.open(str(tmp_path / 'data' / 'shard.tar'), 'w') as tf:
        tf.add(str(tmp_path / 'data' / 'train'), arcname='train')
    extra = [e.format(root=tmp_path / 'data') for e in PORTED[override]]
    trainer = _train(tmp_path, 'run', 1, override, *extra)
    steps = 2 if 'steps_per_dispatch' in override else 1
    assert trainer.global_step == steps
    lines = [json.loads(ln) for ln in open(tmp_path / 'run' / 'metrics.jsonl')]
    assert [ln['step'] for ln in lines] == list(range(steps))
    assert all(np.isfinite(v) for ln in lines for v in ln.values())


def test_validation_data_raises(tmp_path):
    """Validation data of the `online` kind (masks generated on load, ported
    by ROADMAP queue 1 item 10) validates after the epoch, as the other
    kinds do (tests/test_torch_train_val.py)."""
    _write_jpegs(str(tmp_path / 'data' / 'train'))
    save_image(str(tmp_path / 'data' / 'val' / 'v.png'),
               np.random.RandomState(0).rand(64, 64, 3))
    trainer = _train(tmp_path, 'run', 1, 'data.val.img_suffix=.png',
                     'data.val.kind=online',
                     '+data.val.mask_gen_kwargs.segm_proba=0',
                     'evaluator.lpips=false',
                     'evaluator.fid=false', 'evaluator.integral_kind=null')
    lines = [json.loads(ln) for ln in open(tmp_path / 'run' / 'metrics.jsonl')]
    val = [ln for ln in lines if 'val_ssim_total_mean' in ln]
    assert trainer.global_step == 1 and len(val) == 1
    assert np.isfinite(val[0]['val_ssim_total_mean'])


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='device=cpu'):
        port_train.main('big-lama', [f'run_dir={tmp_path}', 'device=cuda'])
