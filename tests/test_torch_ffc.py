"""The port's FFC generator against lama_tpu's on the CPU.

A tiny big-lama-shaped generator (3 downsamplings, ratio 0.75 blocks, no
LFU, sigmoid) is initialised in JAX, carried over with
`state_dict_from_flax`, loaded with strict key matching, and run on the same
64^2 input: fp32, rtol 1e-3 / atol 2e-4, the bounds of the flax-vs-torch
export test (tests/test_export_torch_cli.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lama_tpu.models import make_generator as make_jax_generator
from lama_tpu.training.convert import flax_to_torch
from lama_tpu_torch.convert import state_dict_from_flax
from lama_tpu_torch.models import make_generator
from lama_tpu_torch.models import ffc

torch.set_num_threads(1)

GEN_KW = dict(
    input_nc=4, output_nc=3, ngf=8, n_downsampling=3, n_blocks=2,
    add_out_act='sigmoid',
    init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75, enable_lfu=False),
)


@pytest.fixture(scope='module')
def jax_model():
    gen = make_jax_generator('ffc_resnet', **GEN_KW)
    variables = gen.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 4)),
                         train=False)
    # non-trivial running statistics, so the BN fold is exercised
    rng = np.random.RandomState(5)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.rand(*v.shape).astype(np.float32) * 0.2,
        variables['batch_stats'])
    return gen, {'params': variables['params'], 'batch_stats': stats}


def _port(variables, **kw):
    g = make_generator('ffc_resnet', **GEN_KW, **kw)
    g.load_state_dict(state_dict_from_flax(variables, 3, 2), strict=True)
    return g.eval()


@pytest.mark.parametrize('kernels', ['cuda', 'plain'])
def test_generator_matches_jax(jax_model, kernels):
    gen, variables = jax_model
    x = np.random.RandomState(0).rand(2, 64, 64, 4).astype(np.float32)
    ref = np.asarray(gen.apply(variables, jnp.asarray(x), train=False))
    port = _port(variables, kernels=kernels)
    with torch.no_grad():
        out = port(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))))
    assert out.dtype == torch.float32 and out.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(np.transpose(out.numpy(), (0, 2, 3, 1)), ref,
                               rtol=1e-3, atol=2e-4)


def test_generator_bf16_close_to_fp32(jax_model):
    _, variables = jax_model
    x = torch.rand(1, 4, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = _port(variables)(x)
        out = _port(variables, dtype=torch.bfloat16)(x)
    assert out.dtype == torch.float32   # the sigmoid runs in float32
    assert float((out - ref).abs().max()) < 5e-2


def test_state_dict_from_flax_matches_flax_to_torch(jax_model):
    gen, variables = jax_model
    ours = state_dict_from_flax(variables, 3, 2)
    theirs = flax_to_torch(variables, model=gen)
    assert set(ours) - set(theirs) == {
        k[:-len('running_mean')] + 'num_batches_tracked'
        for k in theirs if k.endswith('.running_mean')}
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    # the reference key-space, e.g. the g2g spectral conv of block 1
    assert 'model.5.conv1.ffc.convg2g.conv1.0.weight' in ours
    assert ours['model.8.weight'].shape == (64, 32, 3, 3)   # ConvT: I, O


def test_fourier_unit_planar_cache_follows_weights():
    fu = ffc.FourierUnit(4, 4).eval()
    w1 = fu.planar()[0]
    assert fu.planar()[0] is w1          # unchanged weights: kept
    with torch.no_grad():
        fu.bn.running_var.mul_(2.0)      # a load or an edit bumps the version
    w2 = fu.planar()[0]
    assert w2 is not w1 and not torch.equal(w1, w2)
    with torch.inference_mode():   # e.g. .to(device) under inference_mode
        fu.bn.running_var = torch.ones(8)
    w3 = fu.planar()[0]
    assert not torch.equal(w2, w3)


@pytest.mark.parametrize('kwargs', [
    dict(resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75,
                                 enable_lfu=True)),
    dict(spatial_transform_layers=[0]),
    dict(out_ffc=True, out_ffc_kwargs=dict(enable_lfu=False)),
    dict(spectral_kwargs=dict(use_se=True)),
    dict(spectral_kwargs=dict(spectral_pos_encoding=True)),
    dict(spectral_kwargs=dict(ffc3d=True)),
    dict(spectral_kwargs=dict(spatial_scale_factor=0.5)),
])
def test_unported_options_raise(kwargs):
    """Item 4's options, once refused here, build and match lama_tpu's
    generator (fp32, 64^2, the bounds above; every option in all three
    stages in tests/test_torch_ffc_options.py). LFU builds an `lfu` unit
    in each block's SpectralTransform."""
    from test_torch_ffc_options import jax_variables
    kw = dict(GEN_KW, **kwargs)
    jgen = make_jax_generator('ffc_resnet', **kw)
    x = np.random.RandomState(1).rand(1, 64, 64, 4).astype(np.float32)
    variables = jax_variables(jgen, jnp.asarray(x), train=False, seed=2)
    ref = np.asarray(jax.jit(lambda v, x: jgen.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    g = make_generator('ffc_resnet', **kw)
    g.load_state_dict(state_dict_from_flax(variables, 3, 2), strict=True)
    if kw['resnet_conv_kwargs']['enable_lfu']:
        assert g.model[5].conv1.ffc.convg2g.lfu is not None
    with torch.no_grad():
        out = g.eval()(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))))
    np.testing.assert_allclose(np.transpose(out.numpy(), (0, 2, 3, 1)), ref,
                               rtol=1e-3, atol=2e-4)


def test_gated_ffc_raises():
    """The gated FFC, once refused, matches lama_tpu's (its `gate` 1x1
    conv weighting the g2l and l2g terms); the multidilated generator,
    once refused beside it, builds, and an unknown kind raises as
    lama_tpu's factory does."""
    from lama_tpu.models.ffc import FFC as JaxFFC
    from lama_tpu_torch.models import MultiDilatedGlobalGenerator
    from test_torch_ffc_options import jax_variables
    rng = np.random.RandomState(3)
    x = tuple(rng.rand(2, 8, 8, 4).astype(np.float32) for _ in range(2))
    jmod = JaxFFC(8, 8, 3, 0.5, 0.5, padding=1, gated=True, enable_lfu=False)
    variables = jax_variables(jmod, tuple(map(jnp.asarray, x)), seed=4)
    ref = jmod.apply(variables, tuple(map(jnp.asarray, x)))
    port = ffc.FFC(8, 8, 3, 0.5, 0.5, padding=1, gated=True,
                   enable_lfu=False)
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert port.gate.weight.shape == (2, 8, 1, 1)
    with torch.no_grad():
        out = port.eval()(tuple(torch.from_numpy(np.transpose(t, (0, 3, 1, 2)))
                                for t in x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(np.transpose(o.numpy(), (0, 2, 3, 1)),
                                   np.asarray(r), rtol=1e-5, atol=1e-5)
    assert isinstance(make_generator('pix2pixhd_multidilated'),
                      MultiDilatedGlobalGenerator)
    with pytest.raises(ValueError, match='Unknown generator kind'):
        make_generator('no_such_kind')


def test_train_mode_raises(jax_model):
    """Train mode runs (tests/test_torch_train_parts.py holds it to the JAX
    generator) and moves the BN statistics; what raises in train mode is a
    batch with one value per channel, by PyTorch's batch-norm rule."""
    from lama_tpu_torch.ops.norm import BatchNorm2d
    _, variables = jax_model
    port = _port(variables).train()
    before = port.model[1].bn_l.running_mean.clone()
    with torch.no_grad():
        out = port(torch.rand(1, 4, 64, 64))
    assert out.shape == (1, 3, 64, 64)
    assert not torch.equal(port.model[1].bn_l.running_mean, before)
    with pytest.raises(ValueError, match='more than 1 value'):
        BatchNorm2d(3).train()(torch.rand(1, 3, 1, 1))
