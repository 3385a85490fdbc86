"""The port's pix2pixHD GlobalGenerator family against lama_tpu's on the CPU.

- ResnetBlock (padding reflect / replicate / zero, dilations, kernel 5,
  `in_dim`, groups) and GlobalGenerator (ngf 8, 2-3 downsamplings, 2
  blocks, the dilated-block options, 64^2) are initialised in JAX, carried
  over with `state_dict_from_flax`, loaded with strict key matching and run
  on the same numpy input, in eval mode and in train mode (outputs and the
  moved BN statistics): fp32, rtol 1e-3 / atol 2e-4, the bounds of the
  flax-vs-torch export test (tests/test_export_torch_cli.py).
- `python -m lama_tpu_torch.predict` against bin/predict.py on a tiny
  pix2pixhd_global model dir: PNGs within one level, known pixels
  bit-equal, both wires the same files; refine=true refused before any
  image is read.
- training: a 3-step fp32 SGD trajectory of a tiny GlobalGenerator against
  lama_tpu's step (tests/test_torch_train.py's harness), and a two-step
  `-cn lama-regular` train CLI run whose checkpoint predict serves;
  big-lama-regular and lama-regular compose to the full-size generator.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_train as ttt
from lama_tpu.data.io import load_image, save_image
from lama_tpu.models import make_generator as make_jax_generator
from lama_tpu.models.pix2pixhd import ResnetBlock as JaxResnetBlock
from lama_tpu.training.convert import flax_to_torch
from lama_tpu_torch import predict as port_predict
from lama_tpu_torch import train as port_train
from lama_tpu_torch.convert import state_dict_from_flax
from lama_tpu_torch.models import make_generator
from lama_tpu_torch.models.pix2pixhd import GlobalGenerator, ResnetBlock
from lama_tpu_torch.ops import conv
from lama_tpu_torch.ops.kernels import halo_conv as thc
from lama_tpu_torch.ops.kernels import reflect_conv as trc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-3, 2e-4
GEN_KW = dict(input_nc=4, output_nc=3, ngf=8, n_downsampling=2, n_blocks=2,
              add_out_act='sigmoid')


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _perturbed_stats(variables, seed):
    """Non-trivial running statistics, so eval-mode BN is exercised."""
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.rand(*v.shape).astype(np.float32) * 0.2,
        variables['batch_stats'])
    return {'params': variables['params'], 'batch_stats': stats}


def _check_train_mode(jax_module, variables, port, x):
    """Train mode: the output and the moved running statistics."""
    ref, upd = jax_module.apply(variables, jnp.asarray(x), train=True,
                                mutable=['batch_stats'])
    port.train()
    with torch.no_grad():
        out = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(out.float()), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    theirs = state_dict_from_flax({'batch_stats': upd['batch_stats']})
    ours = port.state_dict()
    keys = [k for k in theirs if k.endswith(('running_mean', 'running_var'))]
    assert keys
    for k in keys:
        v = theirs[k]
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


BLOCK_CASES = [
    dict(),
    dict(padding_type='replicate'),
    dict(padding_type='zero'),
    dict(dilation=2),
    dict(dilation=2, second_dilation=1),
    dict(kernel_size=5),
    dict(in_dim=8),
    dict(groups=4),
]


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('kw', BLOCK_CASES, ids=lambda kw: ','.join(
    f'{k}={v}' for k, v in kw.items()) or 'default')
def test_resnet_block_matches_jax(kw, train):
    cin = kw.get('in_dim', 16)
    x = np.random.RandomState(1).rand(2, 16, 16, cin).astype(np.float32)
    block = JaxResnetBlock(16, **kw)
    variables = _perturbed_stats(
        block.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 2)
    port = ResnetBlock(16, **kw)
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    if train:
        _check_train_mode(block, variables, port, x)
        return
    ref = block.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = port.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


GEN_CASES = {
    'tiny': {},
    'three_down': dict(n_downsampling=3),
    'dilated': dict(dilated_blocks_n=1, dilated_blocks_n_start=1,
                    dilated_blocks_n_middle=1, max_features=16,
                    up_activation='tanh', add_out_act=True),
}


def _extra_blocks(kw):
    return sum(kw.get(k, 0) for k in ('dilated_blocks_n', 'dilated_blocks_n_start',
                                      'dilated_blocks_n_middle'))


@pytest.fixture(scope='module', params=sorted(GEN_CASES))
def jax_global(request):
    kw = dict(GEN_KW, **GEN_CASES[request.param])
    gen = make_jax_generator('pix2pixhd_global', **kw)
    variables = gen.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 4)),
                         train=False)
    return kw, gen, _perturbed_stats(variables, 5)


def _port(kw, variables, **extra):
    g = make_generator('pix2pixhd_global', **kw, **extra)
    g.load_state_dict(state_dict_from_flax(
        variables, kw['n_downsampling'], kw['n_blocks'], kind='pix2pixhd_global',
        extra_blocks=_extra_blocks(kw)), strict=True)
    return g.eval()


@pytest.mark.parametrize('kernels', ['cuda', 'plain'])
def test_global_generator_matches_jax(jax_global, kernels):
    kw, gen, variables = jax_global
    x = np.random.RandomState(0).rand(2, 64, 64, 4).astype(np.float32)
    ref = np.asarray(gen.apply(variables, jnp.asarray(x), train=False))
    port = _port(kw, variables, kernels=kernels)
    with torch.no_grad():
        out = port(_nchw(x))
    assert out.dtype == torch.float32 and out.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(_nhwc(out), ref, rtol=RTOL, atol=ATOL)


def test_global_generator_train_mode_matches_jax(jax_global):
    kw, gen, variables = jax_global
    x = np.random.RandomState(4).rand(2, 64, 64, 4).astype(np.float32)
    _check_train_mode(gen, variables, _port(kw, variables), x)


def test_state_dict_from_flax_matches_flax_to_torch(jax_global):
    kw, gen, variables = jax_global
    ours = state_dict_from_flax(variables, kw['n_downsampling'],
                                kw['n_blocks'], kind='pix2pixhd_global',
                                extra_blocks=_extra_blocks(kw))
    theirs = flax_to_torch(variables, model=gen)
    assert set(ours) - set(theirs) == {
        k[:-len('running_mean')] + 'num_batches_tracked'
        for k in theirs if k.endswith('.running_mean')}
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    first_up = 4 + 3 * kw['n_downsampling'] + kw['n_blocks'] + _extra_blocks(kw)
    assert isinstance(_port(kw, variables).model[first_up],
                      torch.nn.ConvTranspose2d)


def test_tiny_generator_keys_are_the_reference_indices():
    g = make_generator('pix2pixhd_global', **GEN_KW)
    assert sorted({int(k.split('.')[1]) for k in g.state_dict()}) == [
        1, 2, 4, 5, 7, 8, 10, 11, 12, 13, 15, 16, 19]
    assert 'model.10.conv_block.5.weight' in g.state_dict()
    assert isinstance(g.model[12], torch.nn.ConvTranspose2d)


def test_generator_bf16_close_to_fp32(jax_global):
    kw, _, variables = jax_global
    x = torch.rand(1, 4, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = _port(kw, variables)(x)
        out = _port(kw, variables, dtype=torch.bfloat16)(x)
    assert out.dtype == torch.float32   # the output activation runs in fp32
    assert float((out - ref).abs().max()) < 5e-2


def test_global_generator_routes_its_reflect_convs_to_the_kernels(monkeypatch):
    """Each ResnetBlock conv (3x3 stride 1) goes to kernel 6, the stem to
    kernel 7 and the head to kernel 5; the zero-padded downsamples stay
    stock. On the CPU each wrapper then runs its plain version."""
    picks = []
    kernel_for = conv.kernel_for

    def record(x, weight, *args):
        k = kernel_for(x, weight, *args)
        picks.append(getattr(k, 'func', k))
        return k

    monkeypatch.setattr(conv, 'kernel_for', record)
    g = make_generator('pix2pixhd_global', **GEN_KW).eval()
    with torch.no_grad():
        g(torch.rand(1, 4, 64, 64))
    n = GEN_KW['n_blocks']
    assert picks.count(thc.halo_conv3x3_reflect) == 2 * n
    assert picks.count(thc.halo_conv_reflect_tiled) == 1
    assert picks.count(trc.reflect_out_conv7x7) == 1
    assert picks.count(None) == GEN_KW['n_downsampling']
    assert len(picks) == 2 * n + 2 + GEN_KW['n_downsampling']


@pytest.mark.parametrize('kwargs', [dict(ffc_positions=[0]),
                                    dict(is_resblock_depthwise=True),
                                    dict(conv_kind='depthwise')])
def test_unported_options_raise(kwargs):
    """These options were refused until the rest of the model zoo was
    ported; now each builds the blocks it names (an inline FFCResnetBlock
    with LFU before block 0, a depthwise second conv in every plain block,
    DepthWiseSeparableConv block convs) and runs. tests/
    test_torch_pix2pixhd_extra.py holds each to lama_tpu."""
    from lama_tpu_torch.models.ffc import FFCResnetBlock
    from lama_tpu_torch.models.pix2pixhd import DepthWiseSeparableConv
    g = make_generator('pix2pixhd_global', **GEN_KW, **kwargs).eval()
    blocks = [m for m in g.model if isinstance(m, (ResnetBlock,
                                                   FFCResnetBlock))]
    if 'ffc_positions' in kwargs:
        assert isinstance(blocks[0], FFCResnetBlock)
        assert blocks[0].conv1.ffc.convg2g.lfu is not None
    elif 'is_resblock_depthwise' in kwargs:
        assert all(b.conv_block[5].groups == 32 for b in blocks)
    else:
        assert all(isinstance(b.conv_block[i], DepthWiseSeparableConv)
                   for b in blocks for i in (1, 5))
    with torch.no_grad():
        assert g(torch.rand(1, 4, 64, 64)).shape == (1, 3, 64, 64)


# ------------------------------------------------------------------ serving
SIZES = [(64, 64), (37, 45)]


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """A pix2pixhd_global model dir (weights exported from the JAX model),
    inputs, and both CLIs' fp32 outputs."""
    root = tmp_path_factory.mktemp('serve_global')
    model_dir = root / 'model'
    (model_dir / 'models').mkdir(parents=True)
    cfg = dict(kind='pix2pixhd_global', **GEN_KW)
    with open(model_dir / 'config.yaml', 'w') as f:
        yaml.safe_dump({'generator': cfg}, f)
    gen = make_jax_generator('pix2pixhd_global', **GEN_KW)
    variables = _perturbed_stats(gen.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 4)), train=False), 3)
    sd = {f'generator.{k}': torch.from_numpy(np.array(v))
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
        'bin_predict_global_test', os.path.join(REPO, 'bin', 'predict.py'))
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


def test_bf16_serves_close_to_fp32(served):
    root, common = served
    argv = [a for a in common if not a.startswith('precision=')]
    port_predict.main(argv + [f'outdir={root / "port_bf16"}', 'batch_size=2',
                              'precision=bf16'])
    for i in range(len(SIZES)):
        ours, ref = _read(root, 'port_bf16', i), _read(root, 'port', i)
        mask = load_image(str(root / 'in' / f'img{i}_mask.png'),
                          mode='L', return_orig=True)[1][..., 0]
        np.testing.assert_array_equal(ours[mask == 0], ref[mask == 0])
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 16


def test_refine_is_refused_before_any_work(served, monkeypatch):
    root, common = served
    from lama_tpu_torch import predict

    def no_dataset(*args, **kwargs):
        raise AssertionError('the dataset was read')

    monkeypatch.setattr(predict, 'make_default_val_dataset', no_dataset)
    with pytest.raises(ValueError, match='front and rear stages'):
        port_predict.main(common + [f'outdir={root / "never"}', 'refine=true'])
    assert not (root / 'never').exists()


# ----------------------------------------------------------------- training
@pytest.fixture(scope='module')
def fp32_sgd():
    setup = ttt.make_setup('pix2pixhd_global', GEN_KW)
    return ttt._run(setup, ttt.SGD, torch.float32)


def test_fp32_sgd_trajectory_metrics_match_jax(fp32_sgd):
    ttt._metrics_match(fp32_sgd)


@pytest.mark.parametrize('player', [0, 1], ids=['generator', 'discriminator'])
def test_fp32_bn_running_stats_after_step_one_match_jax(fp32_sgd, player):
    ttt._stats_match(fp32_sgd, player, 1e-5)


@pytest.mark.parametrize('name,n_blocks', [('big-lama-regular', 18),
                                           ('lama-regular', 9)])
def test_regular_configs_compose_the_full_generator(name, n_blocks):
    """The config's generator section (inline in big-lama-regular, the
    `generator: pix2pixhd_global` group in lama-regular) builds the
    full-size GlobalGenerator: ngf 64, 3 downsamplings, 512-channel blocks,
    sigmoid; its parameter count equals the JAX model's (on the meta
    device and through eval_shape: nothing is allocated)."""
    from lama_tpu_torch.config import compose
    cfg = compose(port_train.CONFIG_DIR, name, ['location.data_root_dir=x'])
    kw = dict(cfg.generator)
    assert kw.pop('kind') == 'pix2pixhd_global'
    assert kw == dict(input_nc=4, output_nc=3, ngf=64, n_downsampling=3,
                      n_blocks=n_blocks, add_out_act='sigmoid')
    with torch.device('meta'):
        g = make_generator('pix2pixhd_global', **kw)
    blocks = [m for m in g.model if isinstance(m, ResnetBlock)]
    assert len(blocks) == n_blocks
    assert all(b.conv_block[1].weight.shape == (512, 512, 3, 3) for b in blocks)
    shapes = jax.eval_shape(
        lambda: make_jax_generator('pix2pixhd_global', **kw).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4)), train=False))
    n_jax = sum(int(np.prod(v.shape)) for v in
                jax.tree_util.tree_leaves(shapes['params']))
    assert sum(p.numel() for p in g.parameters()) == n_jax


TINY = ['generator.ngf=8', 'generator.n_downsampling=2',
        'generator.n_blocks=2', 'discriminator.ndf=8',
        'discriminator.n_layers=2', 'data.batch_size=2', 'data.num_workers=1',
        'data.train.out_size=64', 'trainer.kwargs.precision=32',
        'trainer.kwargs.limit_train_batches=1',
        'trainer.kwargs.log_every_n_steps=1',
        'losses.resnet_pl.allow_random_weights=true', 'device=cpu']


def test_lama_regular_trains_and_its_checkpoint_serves(tmp_path):
    """`-cn lama-regular` (the generator group) for two one-step epochs on
    the CPU: finite losses, a GlobalGenerator checkpoint that the predict
    CLI serves, known pixels kept."""
    from test_torch_train_cli import _write_jpegs
    _write_jpegs(str(tmp_path / 'data' / 'train'))
    run = tmp_path / 'run'
    trainer = port_train.main('lama-regular', [
        f'location.data_root_dir={tmp_path / "data"}',
        f'location.out_root_dir={tmp_path}', f'run_dir={run}',
        'trainer.kwargs.max_epochs=2', *TINY])
    assert isinstance(trainer.state.generator, GlobalGenerator)
    assert trainer.global_step == 2
    saved = torch.load(run / 'models' / 'last.ckpt', map_location='cpu',
                       weights_only=False)
    assert 'generator.model.10.conv_block.5.weight' in saved['state_dict']
    with open(run / 'config.yaml') as f:
        assert yaml.safe_load(f)['generator']['kind'] == 'pix2pixhd_global'
    import json
    lines = [json.loads(ln) for ln in open(run / 'metrics.jsonl')]
    assert [ln['step'] for ln in lines] == [0, 1]
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    indir = tmp_path / 'serve_in'
    img = np.random.RandomState(1).rand(64, 64, 3)
    mask = np.zeros((64, 64, 1))
    mask[10:30, 20:44] = 1
    save_image(str(indir / 'a.png'), img)
    save_image(str(indir / 'a_mask.png'), mask)
    port_predict.main([f'model.path={run}', 'model.checkpoint=last.ckpt',
                       f'indir={indir}', f'outdir={tmp_path / "served"}',
                       'device=cpu', 'precision=fp32'])
    out = load_image(str(tmp_path / 'served' / 'a_mask.png'),
                     return_orig=True)[1]
    orig = load_image(str(indir / 'a.png'), return_orig=True)[1]
    assert out.shape == (64, 64, 3)
    known = mask[..., 0] == 0
    np.testing.assert_array_equal(out[known], orig[known])
