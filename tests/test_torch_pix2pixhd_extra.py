"""The rest of the model zoo against lama_tpu's on the CPU: LFU and the
inline FFC block, the GlobalGenerator's `ffc_positions`,
`is_resblock_depthwise` and depthwise blocks, models/pix2pixhd_extra.py and
models/multiscale.py.

Each module gets lama_tpu's variables (eval_shape, filled from numpy)
through `state_dict_from_flax`, loads them with strict key matching and
runs the same numpy input (random, so a transposed tiling or split shows):
fp32, rtol 1e-3 / atol 2e-4, the bounds of the flax-vs-torch export test
(tests/test_export_torch_cli.py), in eval mode and, for the generators, in
train mode (outputs and the moved BN statistics). The state dicts are held
to lama_tpu's flax_to_torch key for key; where flax_to_torch cannot place a
model's ConvTranspose layers (it knows only the FFC and pix2pixHD
generators', lama_tpu/training/convert.py:66-79) their weights are the
same numbers in the (I, O) order that torch's ConvTranspose2d loads.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lama_tpu.models import ffc as jffc
from lama_tpu.models import make_generator as jax_generator
from lama_tpu.models import multiscale as jms
from lama_tpu.models import pix2pixhd as jp
from lama_tpu.models import pix2pixhd_extra as jpx
from lama_tpu.training.convert import flax_to_torch
from lama_tpu_torch.convert import state_dict_from_flax, transposed_conv_names
from lama_tpu_torch.models import ffc as tffc
from lama_tpu_torch.models import make_generator
from lama_tpu_torch.models import multiscale as tms
from lama_tpu_torch.models import pix2pixhd as tp
from lama_tpu_torch.models import pix2pixhd_extra as tpx
from lama_tpu_torch.ops import conv
from lama_tpu_torch.ops.kernels import fourier_unit as tfu
from lama_tpu_torch.ops.kernels import halo_conv as thc
from lama_tpu_torch.ops.kernels import reflect_conv as trc
from test_torch_multidilated import _nchw, _nhwc, variables

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 2e-4
TINY = dict(input_nc=4, output_nc=3, ngf=8, n_downsampling=2, n_blocks=2,
            add_out_act='sigmoid')


def _jax_out(module, v, x, train, **kw):
    fn = jax.jit(functools.partial(module.apply, train=train, **kw,
                                   mutable=['batch_stats'] if train else False))
    return fn(v, jnp.asarray(x) if not isinstance(x, list)
              else [jnp.asarray(t) for t in x])


def _close(ours, theirs):
    np.testing.assert_allclose(_nhwc(ours), np.asarray(theirs), rtol=RTOL,
                               atol=ATOL)


def _stats_match(port, upd):
    theirs = state_dict_from_flax({'batch_stats': upd['batch_stats']})
    ours = port.state_dict()
    keys = [k for k in theirs if k.endswith(('running_mean', 'running_var'))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _keys_match(ours, theirs, transposed=()):
    """ours (state_dict_from_flax) against lama_tpu's flax_to_torch: the
    same keys but for the BNs' num_batches_tracked, the same values, the
    `transposed` modules' ConvTranspose weights with I and O swapped."""
    assert set(ours) - set(theirs) == {
        k[:-len('running_mean')] + 'num_batches_tracked'
        for k in theirs if k.endswith('.running_mean')}
    for k, v in theirs.items():
        if k.rsplit('.', 1)[0] in transposed and k.endswith('weight'):
            v = np.swapaxes(v, 0, 1)
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def _check_generator(jgen, port, x, train_too=True, transposed=None, seed=0,
                     **sd_kw):
    """lama_tpu's generator and the port's on x (NHWC numpy): the keys,
    eval and (train_too) train mode."""
    v = variables(jgen, x, seed=seed, train=False)
    tnames = None if transposed is None else transposed_conv_names(port)
    sd = state_dict_from_flax(v, transposed=tnames, **sd_kw)
    port.load_state_dict(sd, strict=True)
    _keys_match(sd, flax_to_torch(v, model=jgen), tnames or ())
    with torch.no_grad():
        out = port.eval()(_nchw(x))
    _close(out, _jax_out(jgen, v, x, False))
    if train_too:
        ref, upd = _jax_out(jgen, v, x, True)
        with torch.no_grad():
            out = port.train()(_nchw(x))
        _close(out, ref)
        _stats_match(port, upd)
    return port


# -------------------------------------------------------------------- LFU
@pytest.mark.parametrize('stride', [1, 2])
def test_spectral_transform_with_lfu_matches_jax(stride):
    """A 12x16 input (not square) of 32 channels: the LFU takes the first
    quarter of conv1's 16 channels, 4 of them, on four 3x4 (stride 2) or
    6x8 tiles."""
    x = np.random.RandomState(0).randn(2, 12, 16, 32).astype(np.float32)
    jmod = jffc.SpectralTransform(32, stride=stride, enable_lfu=True)
    v = variables(jmod, x, seed=1, train=False)
    port = tffc.SpectralTransform(32, 32, stride=stride, enable_lfu=True)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    assert port.lfu.conv_layer.weight.shape == (32, 32, 1, 1)
    for kernels in ('cuda', 'plain'):
        for m in port.modules():
            if hasattr(m, 'kernels'):
                m.kernels = kernels
        with torch.no_grad():
            out = port.eval()(_nchw(x))
        _close(out, _jax_out(jmod, v, x, False))
    ref, upd = _jax_out(jmod, v, x, True)
    with torch.no_grad():
        out = port.train()(_nchw(x))
    _close(out, ref)
    _stats_match(port, upd)


def test_lfu_refuses_odd_sides():
    port = tffc.SpectralTransform(16, 16, enable_lfu=True).eval()
    with pytest.raises(ValueError, match='even'):
        port(torch.rand(1, 16, 9, 8))


def test_lfu_planar_cache_is_dropped_in_train_mode():
    """The LFU is a FourierUnit of its own: its folded-BN cache follows its
    weights and is dropped by train() (a train-mode forward moves the BN
    statistics inside PyTorch's batch norm), as the main unit's is."""
    port = tffc.SpectralTransform(16, 16, enable_lfu=True).eval()
    w1 = port.lfu.planar()[0]
    assert port.lfu.planar()[0] is w1
    port.train()
    with torch.no_grad():
        port(torch.rand(2, 16, 8, 8))
    port.eval()
    w2 = port.lfu.planar()[0]
    assert w2 is not w1 and not torch.equal(w1, w2)


@pytest.mark.parametrize('kw', [dict(enable_lfu=True),
                                dict(enable_lfu=False, ratio_gin=0.5,
                                     ratio_gout=0.5)],
                         ids=['lfu', 'no-lfu'])
def test_inline_ffc_block_matches_jax(kw):
    x = np.random.RandomState(2).randn(2, 16, 16, 32).astype(np.float32)
    jmod = jffc.FFCResnetBlock(32, inline=True, **kw)
    v = variables(jmod, x, seed=3, train=False)
    port = tffc.FFCResnetBlock(32, inline=True, **kw)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        out = port.eval()(_nchw(x))
    assert isinstance(out, torch.Tensor) and out.shape == (2, 32, 16, 16)
    _close(out, _jax_out(jmod, v, x, False))


def test_ffc_generator_with_lfu_matches_jax():
    """big-lama's generator with LFU in its blocks (generator/
    ffc_resnet_075.yaml turns it off; the reference's default is on)."""
    kw = dict(TINY, init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0),
              downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0),
              resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75,
                                      enable_lfu=True))
    x = np.random.RandomState(4).rand(2, 64, 64, 4).astype(np.float32)
    _check_generator(jax_generator('ffc_resnet', **kw),
                     make_generator('ffc_resnet', **kw), x, n_downsampling=2,
                     n_blocks=2)


# ------------------------------------------------- GlobalGenerator options
GG_CASES = {
    'ffc-lfu': dict(ffc_positions=[0, 1, 1]),
    'ffc-no-lfu': dict(ffc_positions=[1],
                       ffc_kwargs=dict(enable_lfu=False, ratio_gin=0.5,
                                       ratio_gout=0.5)),
    'resblock-depthwise': dict(is_resblock_depthwise=True),
    'depthwise-dilated': dict(conv_kind='depthwise', dilated_blocks_n=1),
}


@pytest.mark.parametrize('name', sorted(GG_CASES))
def test_global_generator_options_match_jax(name):
    kw = dict(TINY, **GG_CASES[name])
    x = np.random.RandomState(5).rand(2, 64, 64, 4).astype(np.float32)
    extra = len(kw.get('ffc_positions', [])) + kw.get('dilated_blocks_n', 0)
    _check_generator(jax_generator('pix2pixhd_global', **kw),
                     make_generator('pix2pixhd_global', **kw), x,
                     n_downsampling=2, n_blocks=2, kind='pix2pixhd_global',
                     extra_blocks=extra)


def test_multidilated_generator_with_ffc_positions_matches_jax():
    kw = dict(TINY, ffc_positions=[1], multidilation_kwargs=dict(
        comb_mode='cat_in', dilation_num=4))
    x = np.random.RandomState(6).rand(1, 64, 64, 4).astype(np.float32)
    _check_generator(jax_generator('pix2pixhd_multidilated', **kw),
                     make_generator('pix2pixhd_multidilated', **kw), x,
                     n_downsampling=2, n_blocks=2,
                     kind='pix2pixhd_multidilated', extra_blocks=1)


def test_ffc_positions_route_the_ffc_convs_to_the_kernels(monkeypatch):
    """At big-lama-regular's width an inline FFC block's l2l conv (128 ->
    128) is kernel 2's shape, its l2g and g2l kernel 3's, its ResnetBlock
    neighbours' kernel 6's (built on the meta device, routed on small
    tensors of those channel counts)."""
    x = torch.rand(1, 128, 8, 8)
    assert conv.kernel_for(x, torch.rand(128, 128, 3, 3), 1, 1, 1, 1,
                           'reflect') is trc.reflect_conv3x3_cols
    assert conv.kernel_for(x, torch.rand(384, 128, 3, 3), 1, 1, 1, 1,
                           'reflect') is trc.reflect_conv3x3_taps
    assert conv.kernel_for(torch.rand(1, 512, 8, 8),
                           torch.rand(512, 512, 3, 3), 1, 1, 1, 1,
                           'reflect') is thc.halo_conv3x3_reflect
    with torch.device('meta'):
        g = make_generator('pix2pixhd_global', ngf=64, n_blocks=2,
                           ffc_positions=[1])
    block = g.model[14]
    assert isinstance(block, tffc.FFCResnetBlock)
    assert block.conv1.ffc.convl2l.weight.shape == (128, 128, 3, 3)
    assert block.conv1.ffc.convg2g.lfu.conv_layer.weight.shape == (
        384, 384, 1, 1)
    # the LFU unit's eval forward goes through the FourierUnit kernel
    calls = []
    monkeypatch.setattr(tfu, 'fused_fourier_unit',
                        lambda *a, **k: calls.append(a[0].shape) or a[0])
    monkeypatch.setattr(tffc, 'fused_fourier_unit', tfu.fused_fourier_unit)
    st = tffc.SpectralTransform(32, 32, enable_lfu=True).eval()
    with torch.no_grad():
        st(torch.rand(2, 32, 8, 8))
    assert calls == [(2, 16, 8, 8), (2, 16, 4, 4)]


# -------------------------------------------------------- pix2pixhd_extra
CONFIG_CASES = {
    'default-md': dict(),
    'bilinear': dict(deconv_kind='bilinear', n_blocks=1),
    'specs': dict(manual_block_spec=[
        dict(n_blocks=1, use_default=True),
        dict(n_blocks=1, resnet_block_kind='resnetblock'),
        dict(n_blocks=1, resnet_block_kind='resnetblock5x5'),
        dict(n_blocks=1, resnet_block_kind='resnetblockdwdil',
             resnet_conv_kind='depthwise', resnet_dilation=2),
        dict(n_blocks=1, resnet_block_kind='multidilatedresnetblock',
             multidilation_kwargs=dict(comb_mode='cat_out',
                                       dilation_num=2))]),
}


@pytest.mark.parametrize('name', sorted(CONFIG_CASES))
def test_config_global_generator_matches_jax(name):
    kw = {**TINY, 'n_blocks': 1, **CONFIG_CASES[name]}
    kw.setdefault('multidilation_kwargs', dict(comb_mode='sum',
                                               dilation_num=2))
    x = np.random.RandomState(7).rand(2, 32, 32, 4).astype(np.float32)
    port = make_generator('config_global', **kw)
    _check_generator(jax_generator('config_global', **kw), port, x,
                     transposed=True)
    assert isinstance(port.model[1], torch.nn.Conv2d)
    assert port.model[1].padding_mode == 'reflect'   # the folded pad


@pytest.mark.parametrize('nd', [2, 3])
def test_super_channels_generator_matches_jax(nd):
    kw = dict(input_nc=4, output_nc=3, n_downsampling=nd, n_blocks=4,
              super_channels=[4, 4, 4, 4, 8, 8, 8, 4, 4][:6 if nd == 2 else 9],
              add_out_act='sigmoid')
    x = np.random.RandomState(8).rand(2, 32, 32, 4).astype(np.float32)
    _check_generator(jax_generator('super_channels', **kw),
                     make_generator('super_channels', **kw), x,
                     transposed=True)


def test_gated_conv_matches_jax():
    x = np.random.RandomState(9).randn(2, 10, 10, 8).astype(np.float32)
    jmod = jpx.GatedConv2d(6, kernel_size=3, stride=2, padding=1)
    v = variables(jmod, x, seed=10)
    port = tpx.GatedConv2d(8, 6, kernel_size=3, stride=2, padding=1)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        _close(port(_nchw(x)), jmod.apply(v, jnp.asarray(x)))


def test_discriminator_as_generator_matches_jax():
    x = np.random.RandomState(11).rand(2, 32, 32, 4).astype(np.float32)
    jmod = jpx.NLayerDiscriminatorAsGen(input_nc=4, ndf=8, n_layers=2)
    v = variables(jmod, x, seed=12, train=False)
    port = tpx.NLayerDiscriminatorAsGen(input_nc=4, ndf=8, n_layers=2)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    assert 'impl.model1.1.running_var' in port.state_dict()
    with torch.no_grad():
        _close(port.eval()(_nchw(x)), _jax_out(jmod, v, x, False))


def test_multi_step_generator_matches_jax():
    """Two GlobalGenerators: the second takes the input and the first's
    output (4 + 3 channels); the outputs come back last first."""
    kw0 = dict(TINY, n_blocks=1)
    kw1 = dict(kw0, input_nc=7)
    x = np.random.RandomState(13).rand(1, 32, 32, 4).astype(np.float32)
    jmod = jpx.SimpleMultiStepGenerator(steps=[
        jp.GlobalGenerator(**kw0), jp.GlobalGenerator(**kw1)])
    v = variables(jmod, x, seed=14, train=False)
    port = tpx.SimpleMultiStepGenerator(
        [tp.GlobalGenerator(**kw0), tp.GlobalGenerator(**kw1)])
    tnames = transposed_conv_names(port)
    sd = state_dict_from_flax(v, transposed=tnames)
    port.load_state_dict(sd, strict=True)
    assert 'steps.1.model.1.weight' in sd
    _keys_match(sd, flax_to_torch(v), tnames)
    with torch.no_grad():
        out = port.eval()(_nchw(x))
    assert out.shape == (1, 6, 32, 32)
    _close(out, _jax_out(jmod, v, x, False))


# ------------------------------------------------------------ multiscale
MS_KW = dict(input_nc=4, output_nc=3, ngf=8, n_downsampling=2,
             n_blocks_head=1, n_blocks_tail=1, n_scales=2)


@pytest.mark.parametrize('kw', [dict(), dict(out_cumulative=True,
                                             out_extra_layers_n=1,
                                             add_out_act='sigmoid'),
                                dict(return_only_hr=True)],
                         ids=['default', 'cumulative', 'only-hr'])
def test_multiscale_resnet_matches_jax(kw):
    kw = dict(MS_KW, **kw)
    x = np.random.RandomState(15).rand(2, 32, 32, 4).astype(np.float32)
    ms = [np.transpose(t.numpy(), (0, 2, 3, 1)) for t in
          tms.make_multiscale_inputs(_nchw(x), 2)]
    jref = jms.make_multiscale_inputs(jnp.asarray(x), 2)
    for a, b in zip(ms, jref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    jmod = jms.MultiscaleResNet(**kw)
    v = variables(jmod, ms, seed=16, train=False)
    port = tms.MultiscaleResNet(**kw)
    tnames = transposed_conv_names(port)
    sd = state_dict_from_flax(v, transposed=tnames)
    port.load_state_dict(sd, strict=True)
    _keys_match(sd, flax_to_torch(v), tnames)
    assert 'tails.0.model.0.weight' in sd     # the 1x1 input projection
    inputs = [_nchw(t) for t in ms]
    for train in (False, True):
        ref = _jax_out(jmod, v, ms, train)
        if train:
            ref, upd = ref
        with torch.no_grad():
            out = port.train(train)(inputs)
        if kw.get('return_only_hr'):
            out, ref = [out], [ref]
        assert len(out) == len(ref)
        for a, b in zip(out, ref):
            _close(a, b)
    _stats_match(port, upd)
    # the coarsest scale only, with the statistics the train step moved
    with torch.no_grad():
        out = port.eval()(inputs[1:], smallest_scales_num=1)
    ref = _jax_out(jmod, dict(v, batch_stats=upd['batch_stats']), ms[1:],
                   False, smallest_scales_num=1)
    if not kw.get('return_only_hr'):
        out, ref = out[0], ref[0]
    _close(out, ref)


def test_multiscale_discriminator_simple_matches_jax():
    from lama_tpu.models.pix2pixhd import NLayerDiscriminator as JaxD
    x = np.random.RandomState(17).rand(2, 32, 32, 3).astype(np.float32)
    ms = [x, x[:, ::2, ::2]]
    jmod = jms.MultiscaleDiscriminatorSimple(
        discriminators=[JaxD(ndf=8, n_layers=2), JaxD(ndf=4, n_layers=1)])
    v = variables(jmod, ms, seed=18, train=False)
    port = tms.MultiscaleDiscriminatorSimple(
        [tp.NLayerDiscriminator(ndf=8, n_layers=2),
         tp.NLayerDiscriminator(ndf=4, n_layers=1)])
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    ref = _jax_out(jmod, v, ms, False)
    with torch.no_grad():
        out = port.eval()([_nchw(t) for t in ms])
    for (score, feats), (rs, rf) in zip(out, ref):
        _close(score, rs)
        for a, b in zip(feats, rf):
            _close(a, b)
    with pytest.raises(ValueError):
        port([_nchw(x)])
