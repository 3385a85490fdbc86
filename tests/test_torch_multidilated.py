"""The port's multidilated family against lama_tpu's on the CPU.

- MultidilatedConv (each comb mode x equal_dim x shuffle_in_channels x
  use_depthwise, reflect; the discriminator's stride-2 4x4 [2, 3] form;
  min_dilation with replicate; zero padding by the 'zero' name),
  DepthWiseSeparableConv and MultidilatedResnetBlock (eval and train) are
  given lama_tpu's variables through `state_dict_from_flax`, loaded with
  strict key matching and run on the same numpy input: fp32, rtol 1e-3 /
  atol 2e-4, the bounds of the flax-vs-torch export test
  (tests/test_export_torch_cli.py).
- The `pix2pixhd_multidilated` generator of configs/training/
  ablv2_work_md.yaml (cat_in, dilation_num 4) at ngf 8, 2 downsamplings, 2
  blocks, 48^2 (a 12^2 bottleneck: the dilation-8 branch's reflect pad of
  8 stays below the side), kernels 'cuda' and 'plain', eval and train;
  its key-space against lama_tpu's flax_to_torch; the routing of its
  branches (dilation 1 to kernel 3, the dilated ones to the stock conv);
  the discriminator `pix2pixhd_nlayer_multidilated`.
- `python -m lama_tpu_torch.predict` on a tiny multidilated model dir
  against bin/predict.py, refine=true refused before any image is read.
- Training: the 3-step fp32 SGD trajectory against lama_tpu's step
  (tests/test_torch_train.py's harness, ablv2_work_md's losses: big-lama's
  l1, r1, feature matching and ResNetPL weights, the pix2pixhd_nlayer D),
  and `-cn ablv2_work_md` through the train CLI for two one-step epochs,
  its checkpoint served; the config composes the full-size generator,
  whose int8 convs are the 72 branch convs, 3 downsamples and 3
  ConvTranspose layers.
"""
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_train as ttt
from lama_tpu.data.io import load_image, save_image
from lama_tpu.models import make_discriminator as jax_discriminator
from lama_tpu.models import make_generator as jax_generator
from lama_tpu.models import pix2pixhd as jp
from lama_tpu.training.convert import flax_to_torch
from lama_tpu_torch import predict as port_predict
from lama_tpu_torch import train as port_train
from lama_tpu_torch.convert import state_dict_from_flax
from lama_tpu_torch.models import (MultiDilatedGlobalGenerator,
                                   make_discriminator, make_generator)
from lama_tpu_torch.models import pix2pixhd as tp
from lama_tpu_torch.ops import conv
from lama_tpu_torch.ops.kernels import halo_conv as thc
from lama_tpu_torch.ops.kernels import reflect_conv as trc
from lama_tpu_torch.ops.serving_mode import ServingMode

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-3, 2e-4
MD_KW = dict(comb_mode='cat_in', dilation_num=4)
GEN_KW = dict(input_nc=4, output_nc=3, ngf=8, n_downsampling=2, n_blocks=2,
              add_out_act='sigmoid', multidilation_kwargs=MD_KW)
S = 48


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def variables(module, x, seed=0, **init_kw):
    """lama_tpu's variable tree for `module` on x, filled from numpy
    (eval_shape, then He-scaled kernels, small biases, BN statistics away
    from the identity), with its 'constants' as lama_tpu's init makes them
    (the in-channel permutation, RandomState(0)); no flax init runs."""
    shapes = jax.eval_shape(functools.partial(module.init, **init_kw),
                            jax.random.PRNGKey(0),
                            jax.tree_util.tree_map(jnp.asarray, x))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if path[0].key == 'constants':
            return np.random.RandomState(0).permutation(shape[0])
        if name == 'kernel':
            a = rng.randn(*shape) * np.sqrt(2 / np.prod(shape[:-1]))
        elif name in ('scale', 'var'):
            a = 1 + 0.2 * rng.rand(*shape)
        else:   # bias, mean
            a = 0.1 * rng.randn(*shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _apply(module, v, x, train=False):
    """lama_tpu's forward, jitted (op by op it takes seconds here); in
    train mode also the moved batch statistics."""
    if not train:
        return np.asarray(jax.jit(functools.partial(
            module.apply, train=False))(v, jnp.asarray(x)))
    out, upd = jax.jit(functools.partial(
        module.apply, train=True, mutable=['batch_stats']))(v, jnp.asarray(x))
    return np.asarray(out), upd


def _check_stats(port, upd):
    theirs = state_dict_from_flax({'batch_stats': upd['batch_stats']})
    ours = port.state_dict()
    keys = [k for k in theirs if k.endswith(('running_mean', 'running_var'))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ----------------------------------------------------------------- the convs
def _conv_case(comb, equal, shuffle, depthwise):
    return dict(comb_mode=comb, equal_dim=equal, shuffle_in_channels=shuffle,
                use_depthwise=depthwise, dilation_num=4,
                padding_mode='reflect')


CONV_CASES = {
    f'{comb}-{"eq" if eq else "uneq"}{"-shuffle" if sh else ""}'
    f'{"-dw" if dw else ""}': _conv_case(comb, eq, sh, dw)
    for comb in ('sum', 'cat_in', 'cat_out', 'cat_both')
    for eq in (True, False) for sh in (False, True) for dw in (False, True)}
# the discriminator's form: 4x4, stride 2, zero padding [2, 3]
CONV_CASES['disc-stride2'] = dict(kernel_size=4, stride=2, padding=[2, 3],
                                  dilation_num=2, comb_mode='sum')
CONV_CASES['min-dilation-replicate'] = dict(min_dilation=2, dilation_num=3,
                                            padding_mode='replicate',
                                            comb_mode='cat_out')
CONV_CASES['zero-name'] = dict(dilation_num=3, padding_mode='zero',
                               comb_mode='sum', stride=2)


@pytest.mark.parametrize('name', sorted(CONV_CASES))
def test_multidilated_conv_matches_jax(name):
    """24 channels in and out (4 equal shares of 6, or 12, 6, 3, 3; the
    uneven cat_out index interleaves 4, 2, 1 and 1 channels), 20^2 (the
    dilation-8 reflect pad of 8 below the side); 21^2 for the stride-2
    discriminator form, whose two branches then agree in size."""
    kw = CONV_CASES[name]
    size = 21 if name == 'disc-stride2' else 20
    x = np.random.RandomState(1).randn(2, size, size, 24).astype(np.float32)
    jmod = jp.MultidilatedConv(24, **kw)
    v = variables(jmod, x, seed=2)
    port = tp.MultidilatedConv(24, 24, **kw)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    ref = np.asarray(jmod.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        out = port(_nchw(x))
    assert out.shape == _nchw(ref).shape
    np.testing.assert_allclose(_nhwc(out), ref, rtol=RTOL, atol=ATOL)


def test_shuffle_permutation_is_lama_tpus_and_a_checkpoint_may_hold_it():
    """The permutation is lama_tpu's draw and out of the state_dict, so
    lama_tpu's exported weights load strictly; a reference checkpoint that
    holds `in_channels_permute` loads it into the buffer."""
    port = tp.MultidilatedConv(24, 24, shuffle_in_channels=True)
    perm = np.random.RandomState(0).permutation(24)
    np.testing.assert_array_equal(port.in_channels_permute.numpy(), perm)
    sd = port.state_dict()
    assert not any('permute' in k for k in sd)
    other = torch.from_numpy(perm[::-1].copy())
    port.load_state_dict(dict(sd, in_channels_permute=other), strict=True)
    assert torch.equal(port.in_channels_permute, other)


@pytest.mark.parametrize('kw', [dict(padding=2, dilation=2,
                                     padding_mode='reflect'),
                                dict(stride=2, padding=1)],
                         ids=['reflect-dilated', 'zeros-stride2'])
def test_depthwise_separable_conv_matches_jax(kw):
    x = np.random.RandomState(3).randn(2, 12, 12, 16).astype(np.float32)
    jmod = jp.DepthWiseSeparableConv(24, **kw)
    v = variables(jmod, x, seed=4)
    port = tp.DepthWiseSeparableConv(16, 24, **kw)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    assert set(port.state_dict()) == {'depthwise.weight', 'depthwise.bias',
                                      'pointwise.weight', 'pointwise.bias'}
    with torch.no_grad():
        out = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(jmod.apply(
        v, jnp.asarray(x))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_multidilated_resnet_block_matches_jax(train):
    x = np.random.RandomState(5).randn(2, 12, 12, 32).astype(np.float32)
    jmod = jp.MultidilatedResnetBlock(32, multidilation_kwargs=MD_KW)
    v = variables(jmod, x, seed=6, train=False)
    port = tp.MultidilatedResnetBlock(32, multidilation_kwargs=MD_KW)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    assert sorted({k.split('.')[1] for k in port.state_dict()}) == [
        '0', '1', '3', '4']
    port.train(train)
    with torch.no_grad():
        out = port(_nchw(x))
    if train:
        ref, upd = _apply(jmod, v, x, train=True)
        _check_stats(port, upd)
    else:
        ref = _apply(jmod, v, x)
    np.testing.assert_allclose(_nhwc(out), ref, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------- the generator
@pytest.fixture(scope='module')
def jax_md():
    gen = jax_generator('pix2pixhd_multidilated', **GEN_KW)
    x = np.random.RandomState(0).rand(2, S, S, 4).astype(np.float32)
    return gen, variables(gen, x, seed=7, train=False), x


def _port(v, **extra):
    g = make_generator('pix2pixhd_multidilated', **GEN_KW, **extra)
    g.load_state_dict(state_dict_from_flax(v, 2, 2,
                                           kind='pix2pixhd_multidilated'),
                      strict=True)
    return g.eval()


@pytest.mark.parametrize('kernels', ['cuda', 'plain'])
def test_multidilated_generator_matches_jax(jax_md, kernels):
    gen, v, x = jax_md
    port = _port(v, kernels=kernels)
    assert isinstance(port, MultiDilatedGlobalGenerator)
    with torch.no_grad():
        out = port(_nchw(x))
    assert out.dtype == torch.float32 and out.shape == (2, 3, S, S)
    np.testing.assert_allclose(_nhwc(out), _apply(gen, v, x), rtol=RTOL,
                               atol=ATOL)


def test_multidilated_generator_train_mode_matches_jax(jax_md):
    gen, v, x = jax_md
    port = _port(v).train()
    with torch.no_grad():
        out = port(_nchw(x))
    ref, upd = _apply(gen, v, x, train=True)
    np.testing.assert_allclose(_nhwc(out), ref, rtol=RTOL, atol=ATOL)
    _check_stats(port, upd)


def test_multidilated_state_dict_matches_flax_to_torch(jax_md):
    gen, v, _ = jax_md
    ours = state_dict_from_flax(v, 2, 2, kind='pix2pixhd_multidilated')
    theirs = flax_to_torch(v, model=gen)
    assert set(ours) - set(theirs) == {
        k[:-len('running_mean')] + 'num_batches_tracked'
        for k in theirs if k.endswith('.running_mean')}
    for k, val in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), val, err_msg=k)
    assert ours['model.10.conv_block.3.convs.3.weight'].shape == (32, 8, 3, 3)
    assert ours['model.12.weight'].shape == (32, 16, 3, 3)   # ConvT: I, O
    assert isinstance(_port(v).model[12], torch.nn.ConvTranspose2d)


def test_multidilated_generator_bf16_close_to_fp32(jax_md):
    _, v, x = jax_md
    with torch.no_grad():
        ref = _port(v)(_nchw(x))
        out = _port(v, dtype=torch.bfloat16)(_nchw(x))
    assert out.dtype == torch.float32
    assert float((out - ref).abs().max()) < 5e-2


def test_multidilated_branches_route_by_dilation(monkeypatch):
    """In every MultidilatedConv (cat_in, 4 branches, reflect) the dilation-1
    branch takes kernel 6 here (its 8 -> 32 channels are off kernel 3's
    multiples of 128; at ngf 64 it is 128 -> 512, kernel 3's shape), the
    dilated ones the stock conv, as do the zero-padded downsamples; the
    stem takes kernel 7 and the head kernel 5."""
    picks = []
    kernel_for = conv.kernel_for

    def record(x, weight, stride, padding, dilation, *args):
        k = kernel_for(x, weight, stride, padding, dilation, *args)
        picks.append((conv._pair(dilation)[0], getattr(k, 'func', k)))
        return k

    monkeypatch.setattr(conv, 'kernel_for', record)
    g = make_generator('pix2pixhd_multidilated', **GEN_KW).eval()
    with torch.no_grad():
        g(torch.rand(1, 4, S, S))
    n_md = 2 * GEN_KW['n_blocks']
    assert [k for d, k in picks if d == 1].count(
        thc.halo_conv3x3_reflect) == n_md
    dilated = [(d, k) for d, k in picks if d != 1]
    assert sorted(dilated, key=lambda p: p[0]) == sorted(
        [(d, None) for d in (2, 4, 8)] * n_md, key=lambda p: p[0])
    assert picks.count((1, thc.halo_conv_reflect_tiled)) == 1
    assert picks.count((1, trc.reflect_out_conv7x7)) == 1
    assert picks.count((1, None)) == GEN_KW['n_downsampling']
    # at the shipped width the dilation-1 branch is kernel 3's shape
    x = torch.rand(1, 128, 16, 16)
    w = torch.rand(512, 128, 3, 3)
    assert conv.kernel_for(x, w, 1, 1, 1, 1, 'reflect') is \
        trc.reflect_conv3x3_taps
    assert conv.kernel_for(x, w, 1, 8, 8, 1, 'reflect') is None


def test_multidilated_discriminator_matches_jax():
    kw = dict(input_nc=3, ndf=8, n_layers=3,
              multidilation_kwargs=dict(dilation_num=2))
    x = np.random.RandomState(8).rand(2, 64, 64, 3).astype(np.float32)
    jd = jax_discriminator('pix2pixhd_nlayer_multidilated', **kw)
    v = variables(jd, x, seed=9, train=False)
    port = make_discriminator('pix2pixhd_nlayer_multidilated', **kw)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    assert 'model2.0.convs.1.weight' in port.state_dict()
    for train in (False, True):
        port.train(train)
        if train:
            (ref, feats), upd = jd.apply(v, jnp.asarray(x), train=True,
                                         mutable=['batch_stats'])
        else:
            ref, feats = jd.apply(v, jnp.asarray(x), train=False)
        with torch.no_grad():
            score, ours = port(_nchw(x))
        np.testing.assert_allclose(_nhwc(score), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
        assert len(ours) == len(feats)
        for a, b in zip(ours, feats):
            np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
    _check_stats(port, upd)


def test_int8_generator_layers_match_jax_on_its_inputs():
    """int8 at fp32 compute, ngf 16 (64-channel blocks, 16 channels a
    branch), reflect and zero_pad: each layer of the port's generator, fed
    lama_tpu's own input to it, gives lama_tpu's output within 1e-5 of its
    largest value. (End to end the two may differ by one int8 code: where
    an fp32 activation sits within its ~1e-7 rounding difference of a code
    boundary, here in the first ConvTranspose's input, the code flips;
    tests/test_torch_int8.py holds the whole generator at ngf 8.)"""
    from test_torch_int8 import GATES, jax_init
    from lama_tpu.ops.serving_mode import ServingMode as JaxMode
    kw = dict(GEN_KW, ngf=16, n_blocks=1)
    x = np.random.RandomState(0).rand(1, S, S, 4).astype(np.float32)
    for zero_pad in (False, True):
        jgen = jax_generator('pix2pixhd_multidilated', serving_mode=JaxMode(
            int8=True, zero_pad=zero_pad, **GATES), **kw)
        v = jax_init(jgen, x, seed=3)
        _, state = jgen.apply(v, jnp.asarray(x), train=False,
                              capture_intermediates=True)
        inter = {int(k[len('model_'):]): np.asarray(val['__call__'][0])
                 for k, val in state['intermediates'].items()
                 if k.startswith('model_')}
        port = make_generator('pix2pixhd_multidilated', **kw,
                              serving_mode=ServingMode(
                                  int8=True, zero_pad=zero_pad, **GATES))
        port.load_state_dict(state_dict_from_flax(
            v, 2, 1, kind='pix2pixhd_multidilated'), strict=True)
        port.eval()
        assert sum(getattr(m, 'quantized', False) for m in port.modules()) \
            == 2 + 8 + 2
        prev, inp = -1, x
        for i in sorted(inter):
            with torch.no_grad():
                out = port.model[prev + 1:i + 1](_nchw(inp))
            scale = float(np.abs(inter[i]).max())
            np.testing.assert_allclose(_nhwc(out), inter[i], rtol=0,
                                       atol=1e-5 * scale, err_msg=str(i))
            prev, inp = i, inter[i]


# ------------------------------------------------------------------ serving
SIZES = [(48, 48), (37, 45)]


@pytest.fixture(scope='module')
def served(tmp_path_factory, jax_md):
    """A tiny pix2pixhd_multidilated model dir (lama_tpu's variables
    exported by flax_to_torch), its inputs and both CLIs' fp32 outputs."""
    gen, v, _ = jax_md
    root = tmp_path_factory.mktemp('serve_md')
    model_dir = root / 'model'
    (model_dir / 'models').mkdir(parents=True)
    with open(model_dir / 'config.yaml', 'w') as f:
        yaml.safe_dump({'generator': dict(kind='pix2pixhd_multidilated',
                                          **GEN_KW)}, f)
    sd = {f'generator.{k}': torch.from_numpy(np.array(val))
          for k, val in flax_to_torch(v, model=gen).items()}
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
        'bin_predict_md_test', os.path.join(REPO, 'bin', 'predict.py'))
    jax_predict = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_predict)
    # pad to 48, so the 37x45 image's bottleneck keeps the dilation-8 pad
    # below its side
    common = [f'model.path={model_dir}', f'indir={indir}', 'device=cpu',
              'precision=fp32', 'dataset.pad_out_to_modulo=48']
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
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1
        img = load_image(str(root / 'in' / f'img{i}.png'), return_orig=True)[1]
        mask = load_image(str(root / 'in' / f'img{i}_mask.png'),
                          mode='L', return_orig=True)[1][..., 0]
        np.testing.assert_array_equal(ours[mask == 0], img[mask == 0])
        assert np.abs(ours[mask > 0].astype(int) - img[mask > 0]).max() > 0


def test_int8_serve_keeps_known_pixels(served):
    root, common = served
    argv = [a for a in common if not a.startswith('precision=')]
    port_predict.main(argv + [f'outdir={root / "int8"}', 'precision=int8',
                              'quant_zero_pad=true', 'quant_calibration=1'])
    for i in range(len(SIZES)):
        ours, ref = _read(root, 'int8', i), _read(root, 'port', i)
        mask = load_image(str(root / 'in' / f'img{i}_mask.png'),
                          mode='L', return_orig=True)[1][..., 0]
        np.testing.assert_array_equal(ours[mask == 0], ref[mask == 0])


def test_refine_is_refused_before_any_work(served, monkeypatch):
    root, common = served

    def no_dataset(*args, **kwargs):
        raise AssertionError('the dataset was read')

    monkeypatch.setattr(port_predict, 'make_default_val_dataset', no_dataset)
    with pytest.raises(ValueError, match='front and rear stages'):
        port_predict.main(common + [f'outdir={root / "never"}', 'refine=true'])
    assert not (root / 'never').exists()


# ----------------------------------------------------------------- training
@pytest.fixture(scope='module')
def fp32_sgd():
    return ttt._run(ttt.make_setup('pix2pixhd_multidilated', GEN_KW),
                    ttt.SGD, torch.float32)


def test_fp32_sgd_trajectory_metrics_match_jax(fp32_sgd):
    ttt._metrics_match(fp32_sgd)


@pytest.mark.parametrize('player', [0, 1], ids=['generator', 'discriminator'])
def test_fp32_bn_running_stats_after_step_one_match_jax(fp32_sgd, player):
    ttt._stats_match(fp32_sgd, player, 1e-5)


def _ablv2_generator():
    from lama_tpu_torch.config import compose
    cfg = compose(port_train.CONFIG_DIR, 'ablv2_work_md',
                  ['location.data_root_dir=x'])
    kw = dict(cfg.generator)
    assert kw.pop('kind') == 'pix2pixhd_multidilated'
    kw['multidilation_kwargs'] = dict(kw['multidilation_kwargs'])
    return kw


def test_ablv2_work_md_composes_the_full_generator():
    """ngf 64, 3 downsamplings, 9 MultidilatedResnetBlocks whose branch
    convs are 128 -> 512 at dilations 1, 2, 4, 8; the parameter count of
    lama_tpu's (eval_shape and the meta device: nothing is allocated); in
    int8 its 72 branch convs, 3 downsamples and 3 ConvTranspose layers
    quantize, the stem and the head do not."""
    kw = _ablv2_generator()
    assert kw == dict(input_nc=4, output_nc=3, ngf=64, n_downsampling=3,
                      n_blocks=9, add_out_act='sigmoid',
                      multidilation_kwargs=MD_KW)
    with torch.device('meta'):
        g = make_generator('pix2pixhd_multidilated', **kw)
        q = make_generator('pix2pixhd_multidilated',
                           serving_mode=ServingMode(int8=True), **kw)
    branches = [m for m in g.modules() if isinstance(m, tp.MultidilatedConv)]
    assert len(branches) == 18
    assert all(c.weight.shape == (512, 128, 3, 3) and c.dilation == (d, d)
               for b in branches for c, d in zip(b.convs, (1, 2, 4, 8)))
    shapes = jax.eval_shape(
        lambda: jax_generator('pix2pixhd_multidilated', **kw).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4)), train=False))
    assert sum(p.numel() for p in g.parameters()) == sum(
        int(np.prod(v.shape))
        for v in jax.tree_util.tree_leaves(shapes['params']))
    quantized = [n for n, m in q.named_modules()
                 if getattr(m, 'quantized', False)]
    assert len(quantized) == 78
    assert 'model.22' in quantized   # the first ConvTranspose
    assert 'model.1' not in quantized and 'model.32' not in quantized


TINY = ['generator.ngf=8', 'generator.n_downsampling=2',
        'generator.n_blocks=2', 'discriminator.ndf=8',
        'discriminator.n_layers=2', 'data.batch_size=2', 'data.num_workers=1',
        'data.train.out_size=64', 'trainer.kwargs.precision=32',
        'trainer.kwargs.limit_train_batches=1',
        'trainer.kwargs.log_every_n_steps=1',
        'losses.resnet_pl.allow_random_weights=true', 'device=cpu']


def test_ablv2_work_md_trains_and_its_checkpoint_serves(tmp_path):
    """`-cn ablv2_work_md` as shipped but for the tiny sizes, two one-step
    epochs on the CPU: finite losses, a multidilated checkpoint that the
    predict CLI serves, known pixels kept."""
    from test_torch_train_cli import _write_jpegs
    _write_jpegs(str(tmp_path / 'data' / 'train'))
    run = tmp_path / 'run'
    trainer = port_train.main('ablv2_work_md', [
        f'location.data_root_dir={tmp_path / "data"}',
        f'location.out_root_dir={tmp_path}', f'run_dir={run}',
        'trainer.kwargs.max_epochs=2', *TINY])
    assert isinstance(trainer.state.generator, MultiDilatedGlobalGenerator)
    assert trainer.global_step == 2
    saved = torch.load(run / 'models' / 'last.ckpt', map_location='cpu',
                       weights_only=False)
    assert 'generator.model.10.conv_block.3.convs.3.weight' in \
        saved['state_dict']
    lines = [json.loads(ln) for ln in open(run / 'metrics.jsonl')]
    assert [ln['step'] for ln in lines] == [0, 1]
    assert all(np.isfinite(val) for ln in lines for val in ln.values())
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
