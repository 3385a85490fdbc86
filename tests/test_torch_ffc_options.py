"""The FFC options (lama_tpu/models/ffc.py) in the port against lama_tpu
on the CPU.

Each option alone on a tiny big-lama-shaped generator (ngf 8, 3
downsamplings, 2 blocks, ratio 0.75, no LFU, sigmoid; out_ffc at ngf 16,
where its default LFU has channels) at 64^2: lama_tpu's variables filled
from numpy, carried by `state_dict_from_flax` and loaded strictly, the
stages 'full', 'front' and 'rear' (the rear on lama_tpu's front output),
fp32, rtol 1e-3 / atol 2e-4 (the bounds of tests/test_torch_ffc.py). Then
train-mode forwards, the modules alone (FFCSE_block, gated and grouped
FFCs), float64 gradients against jax.grad, the 'forward' norm against
both of lama_tpu's FFT paths, and int8 serving of the opt_st_outffc
generator. The ops of item 2 (area resizes, erosion, dilation) are in
tests/test_torch_ffc_options_ops.py.
"""
import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_common as ttc
from lama_tpu.models import ffc as jffc
from lama_tpu.models import make_generator as jax_make
from lama_tpu.ops.serving_mode import ServingMode as JaxMode
from lama_tpu_torch.convert import state_dict_from_flax
from lama_tpu_torch.models import ffc
from lama_tpu_torch.models import make_generator
from lama_tpu_torch.ops.kernels import fourier_unit as fu
from lama_tpu_torch.ops.serving_mode import ServingMode

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 2e-4
SIZE = 64
GEN_KW = dict(
    input_nc=4, output_nc=3, ngf=8, n_downsampling=3, n_blocks=2,
    add_out_act='sigmoid',
    init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75, enable_lfu=False),
)
# option: (generator kwargs of both, lama_tpu's own spectral kwargs)
OPTIONS = {
    'norm_ortho': (dict(spectral_kwargs=dict(fft_norm='ortho')), {}),
    'norm_backward': (dict(spectral_kwargs=dict(fft_norm='backward')), {}),
    # lama_tpu's DFT path scales 'forward' as 'backward'; its jnp.fft path
    # is torch.fft's (test_forward_norm_differs_from_lama_tpu_dft)
    'norm_forward': (dict(spectral_kwargs=dict(fft_norm='forward')),
                     dict(use_dft_matmul=False)),
    'scale_bilinear': (dict(spectral_kwargs=dict(
        spatial_scale_factor=0.5, spatial_scale_mode='bilinear')), {}),
    'scale_nearest': (dict(spectral_kwargs=dict(
        spatial_scale_factor=0.5, spatial_scale_mode='nearest')), {}),
    'scale_area': (dict(spectral_kwargs=dict(
        spatial_scale_factor=0.5, spatial_scale_mode='area')), {}),
    'pos_encoding': (dict(spectral_kwargs=dict(spectral_pos_encoding=True)),
                     {}),
    'se': (dict(spectral_kwargs=dict(use_se=True)), {}),
    'ffc3d': (dict(spectral_kwargs=dict(ffc3d=True)), {}),
    # chip_smoke.py's opt_plain_units: the three together
    'plain_units': (dict(spectral_kwargs=dict(
        spectral_pos_encoding=True, use_se=True, ffc3d=True)), {}),
    'spatial_transform': (dict(spatial_transform_layers=[1]), {}),
    'out_ffc': (dict(out_ffc=True, ngf=16), {}),
}
STAGES = ('full', 'front', 'rear')
# the reference init's scale times this, so the sigmoid output leaves 0.5
WEIGHT_GAIN = 3.0


def jax_variables(module, x, *args, seed=0, **kwargs):
    """The variables of `module.init(key, x, *args, **kwargs)` filled from
    numpy (eval_shape, then numpy: flax's init of a generator takes 10-25
    s here): kernels uniform in +-WEIGHT_GAIN / sqrt(fan in), biases
    0.05 U(-1, 1), BN scales 1 + 0.1 U, running means 0.1 N(0, 1),
    running variances 1 + 0.3 U(0, 1), spatial transform angles U(0, 80)
    degrees."""
    shapes = jax.eval_shape(functools.partial(module.init, **kwargs),
                            jax.random.PRNGKey(0), x, *args)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            a = (rng.uniform(-1, 1, shape) * WEIGHT_GAIN
                 / np.sqrt(np.prod(shape[:-1])))
        elif name == 'scale':
            a = 1 + 0.1 * rng.uniform(-1, 1, shape)
        elif name == 'mean':
            a = 0.1 * rng.randn(*shape)
        elif name == 'var':
            a = 1 + 0.3 * rng.rand(*shape)
        elif name == 'angle':
            a = rng.uniform(0, 80, shape)
        else:
            a = 0.05 * rng.uniform(-1, 1, shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _input(b=2, size=SIZE, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.rand(b, size, size, 3).astype(np.float32)
    mask = np.zeros((b, size, size, 1), np.float32)
    mask[:, size // 4:3 * size // 4, size // 8:size // 2] = 1.0
    return np.concatenate([img * (1 - mask), mask], axis=-1)


def nchw(a):
    return None if a is None else torch.from_numpy(
        np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t):
    return None if t is None else t.detach().permute(0, 2, 3, 1).numpy()


def _gen_kwargs(option):
    kw, jax_spectral = OPTIONS[option]
    gkw = dict(GEN_KW, **kw)
    jkw = dict(gkw, spectral_kwargs=dict(gkw.get('spectral_kwargs') or {},
                                         **jax_spectral))
    return gkw, jkw


def port_generator(gkw, variables, **kw):
    g = make_generator('ffc_resnet', **gkw, **kw)
    g.load_state_dict(state_dict_from_flax(
        variables, gkw['n_downsampling'], gkw['n_blocks']), strict=True)
    return g


@functools.lru_cache(maxsize=None)
def case(option):
    """lama_tpu's generator with `option`, its variables, an input and its
    three stages' outputs (one jitted program: full, front, and the rear on
    that front)."""
    gkw, jkw = _gen_kwargs(option)
    jgen = jax_make('ffc_resnet', **jkw)
    x = _input()
    variables = jax_variables(jgen, jnp.asarray(x), train=False)

    @jax.jit
    def stages(v, x):
        front = jgen.apply(v, x, train=False, stage='front')
        return (jgen.apply(v, x, train=False), front,
                jgen.apply(v, front, train=False, stage='rear'))
    full, front, rear = jax.tree_util.tree_map(
        lambda a: None if a is None else np.asarray(a),
        stages(variables, jnp.asarray(x)))
    return types.SimpleNamespace(gkw=gkw, jgen=jgen, variables=variables,
                                 x=x, full=full, front=front, rear=rear)


@pytest.mark.parametrize('stage', STAGES)
@pytest.mark.parametrize('option', sorted(OPTIONS))
def test_option_matches_lama_tpu(option, stage):
    c = case(option)
    port = port_generator(c.gkw, c.variables).eval()
    with torch.no_grad():
        if stage == 'full':
            pairs = [(port(nchw(c.x)), c.full)]
        elif stage == 'front':
            pairs = list(zip(port(nchw(c.x), stage='front'), c.front))
        else:
            pairs = [(port(tuple(nchw(t) for t in c.front), stage='rear'),
                      c.rear)]
    for ours, ref in pairs:
        assert (ours is None) == (ref is None)
        if ref is not None:
            np.testing.assert_allclose(nhwc(ours.float()), ref, rtol=RTOL,
                                       atol=ATOL)


def test_options_build_the_modules_they_name():
    """Each option reaches the modules lama_tpu builds for it, and the
    FourierUnit's route follows lama_tpu's fused-kernel gate."""
    def first_fu(g):
        return next(m for m in g.modules() if isinstance(m, ffc.FourierUnit))
    gkw = _gen_kwargs('spatial_transform')[0]
    g = make_generator('ffc_resnet', **gkw)
    assert isinstance(g.model[6], ffc.LearnableSpatialTransformWrapper)
    assert g.model[6].angle.shape == (1,)
    g = make_generator('ffc_resnet', **_gen_kwargs('out_ffc')[0])
    assert isinstance(g.model[17], ffc.FFCResnetBlock)
    assert g.model[19].weight.shape == (3, 16, 7, 7)   # the head, one on
    for option, routed in (('se', False), ('pos_encoding', False),
                           ('ffc3d', False), ('norm_backward', True),
                           ('scale_area', True)):
        fu_ = first_fu(make_generator('ffc_resnet',
                                      **_gen_kwargs(option)[0]))
        assert fu_.kernel_route == routed, option
    fu_ = first_fu(make_generator('ffc_resnet', **_gen_kwargs('se')[0]))
    assert fu_.conv_layer.in_channels == 48 and fu_.se.fc[0].weight.shape \
        == (3, 48)
    fu_ = first_fu(make_generator('ffc_resnet',
                                  **_gen_kwargs('pos_encoding')[0]))
    assert fu_.conv_layer.in_channels == 50


# ------------------------------------------------------------ train mode
TRAIN_OPTIONS = {
    'combined': dict(spatial_transform_layers=[0], spectral_kwargs=dict(
        spectral_pos_encoding=True, use_se=True, fft_norm='backward',
        spatial_scale_factor=0.5, spatial_scale_mode='area')),
    'ffc3d_out_ffc': dict(out_ffc=True, out_ffc_kwargs=dict(enable_lfu=False),
                          spectral_kwargs=dict(ffc3d=True)),
}


@pytest.mark.parametrize('option', sorted(TRAIN_OPTIONS))
def test_train_mode_matches_lama_tpu(option):
    """A train-mode forward (batch-statistics BN, every FourierUnit on the
    plain path) and the running statistics it leaves."""
    gkw = dict(GEN_KW, **TRAIN_OPTIONS[option])
    jgen = jax_make('ffc_resnet', **gkw)
    x = _input(seed=1)
    variables = jax_variables(jgen, jnp.asarray(x), train=False, seed=2)
    ref, upd = jax.jit(lambda v, x: jgen.apply(
        v, x, train=True, mutable=['batch_stats']))(variables, jnp.asarray(x))
    port = port_generator(gkw, variables).train()
    with torch.no_grad():
        out = port(nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    moved = state_dict_from_flax(
        {'params': variables['params'], 'batch_stats': upd['batch_stats']},
        gkw['n_downsampling'], gkw['n_blocks'])
    sd = port.state_dict()
    for k, v in moved.items():
        if 'running' in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


# ------------------------------------------------------- the modules alone
def _streams(b, c_l, c_g, size, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, size, size, c_l).astype(np.float32) - 0.5,
            rng.rand(b, size, size, c_g).astype(np.float32) - 0.5)


def _load(module, variables, **kw):
    module.load_state_dict(state_dict_from_flax(variables, **kw),
                           strict=True)
    return module.eval()


@pytest.mark.parametrize('ratio_g', [0.5, 0.0, 0.75])
def test_ffcse_block_matches_lama_tpu(ratio_g):
    channels = 32
    c_g = int(channels * ratio_g)
    xl, xg = _streams(2, channels - c_g, c_g, 8, 3)
    x = (None if c_g == channels else jnp.asarray(xl),
         None if c_g == 0 else jnp.asarray(xg))
    jmod = jffc.FFCSE_block(channels, ratio_g)
    variables = jax_variables(jmod, x, seed=4)
    ref = jmod.apply(variables, x)
    port = _load(ffc.FFCSE_block(channels, ratio_g), variables)
    assert (port.conv_a2l is None) == (c_g == channels)
    assert (port.conv_a2g is None) == (c_g == 0)
    with torch.no_grad():
        out = port(tuple(nchw(t) for t in x))
    for o, r in zip(out, ref):
        assert (o is None) == (r is None)
        if r is not None:
            np.testing.assert_allclose(nhwc(o), np.asarray(r), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize('gated,groups', [(True, 1), (False, 2), (True, 2),
                                          (False, 4)])
def test_gated_and_grouped_ffc_match_lama_tpu(gated, groups):
    """The FFC as a module (3x3 reflect, ratio 0.5, 16 -> 16 channels):
    the gate's 1x1 conv and its sigmoid on the g2l and l2g terms; grouped
    l2l, l2g and g2l convs and the SpectralTransform's groups // 2."""
    xl, xg = _streams(2, 8, 8, 16, 5)
    x = (jnp.asarray(xl), jnp.asarray(xg))
    jmod = jffc.FFC(16, 16, 3, 0.5, 0.5, padding=1, groups=groups,
                    gated=gated, enable_lfu=False)
    variables = jax_variables(jmod, x, seed=6)
    ref = jmod.apply(variables, x)
    port = _load(ffc.FFC(16, 16, 3, 0.5, 0.5, padding=1, groups=groups,
                         gated=gated, enable_lfu=False), variables)
    assert (port.gate is None) != gated
    assert port.convl2l.groups == groups
    assert port.convg2g.fu.groups == (1 if groups == 1 else groups // 2)
    with torch.no_grad():
        out = port(tuple(nchw(t) for t in x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(nhwc(o), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------- float64 gradients
@contextlib.contextmanager
def float64_spectral():
    """lama_tpu's FourierUnit casts its FFT input and its spectral conv to
    float32 whatever the compute type (models/ffc.py:217, :229, :306), and
    its BN computes in float32: inside this block they read float64, so
    the gradients compare far below float32 rounding."""
    saved = jffc.jnp
    jffc.jnp = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                        if not k.startswith('__')})
    jffc.jnp.float32 = jnp.float64
    try:
        with jax.enable_x64(True), ttc.float64_batchnorm():
            yield
    finally:
        jffc.jnp = saved


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _grad_check(jmod, port, variables, x, wrt, jax_kwargs, load_kw):
    """d sum(out * r) / d params[wrt] in float64, lama_tpu (jax.grad, eval
    mode) against the port (autograd): within rtol 1e-6 and 1e-6 of the
    largest (float32 rounding would show near 1e-3)."""
    with float64_spectral():
        v64 = _f64(variables)
        xj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), x)
        out = jmod.apply(v64, xj, **jax_kwargs)
        rs = jax.tree_util.tree_map(
            lambda o: np.random.RandomState(9).rand(*o.shape), out)

        def loss(params):
            o = jmod.apply({**v64, 'params': params}, xj, **jax_kwargs)
            return sum(jnp.sum(a * r) for a, r in zip(
                jax.tree_util.tree_leaves(o), jax.tree_util.tree_leaves(rs)))
        grads = jax.jit(jax.grad(loss))(v64['params'])
    port = _load(port, variables, **load_kw).double()
    xt = jax.tree_util.tree_map(lambda a: nchw(np.asarray(a, np.float64)), x)
    out = port(xt)
    out = out if isinstance(out, tuple) else (out,)
    total = sum((o * nchw(r)).sum() for o, r in zip(
        out, jax.tree_util.tree_leaves(rs)))
    total.backward()
    ref = state_dict_from_flax({'params': grads}, **load_kw)
    named = dict(port.named_parameters())
    for key in wrt:
        ours = named[key].grad.numpy()
        scale = np.abs(ref[key].numpy()).max()
        assert scale > 0, key
        np.testing.assert_allclose(ours, ref[key].numpy(), rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=key)


def test_angle_and_se_gradients_match_jax_grad():
    """The generator's spatial transform angle and the SE weights of a
    wrapped block's FourierUnits."""
    gkw = dict(GEN_KW, spatial_transform_layers=[0],
               spectral_kwargs=dict(use_se=True))
    jgen = jax_make('ffc_resnet', **dict(gkw, spectral_kwargs=dict(
        use_se=True, use_dft_matmul=False)))
    x = _input(b=1, size=32, seed=4)
    # seed 7: some of each SE's 3 hidden ReLUs are live (at seed 5 none of
    # the first unit's are, and its SE gradients are exactly 0)
    variables = jax_variables(jgen, jnp.asarray(x), train=False, seed=7)
    se = 'model.5.impl.conv1.ffc.convg2g.fu.se.fc.'
    _grad_check(jgen, make_generator('ffc_resnet', dtype=torch.float64,
                                     **gkw), variables, x,
                ['model.5.angle', se + '0.weight', se + '2.weight'],
                dict(train=False), dict(n_downsampling=3, n_blocks=2))


def test_gate_gradient_matches_jax_grad():
    xl, xg = _streams(1, 8, 8, 8, 7)
    jmod = jffc.FFC(16, 16, 3, 0.5, 0.5, padding=1, gated=True,
                    enable_lfu=False,
                    spectral_kwargs=dict(use_dft_matmul=False))
    x = (xl, xg)
    variables = jax_variables(jmod, tuple(map(jnp.asarray, x)), seed=8)
    _grad_check(jmod, ffc.FFC(16, 16, 3, 0.5, 0.5, padding=1, gated=True,
                              enable_lfu=False), variables, x,
                ['gate.weight', 'gate.bias'], {}, {})


def test_untrained_angle_gets_no_gradient():
    wrap = ffc.LearnableSpatialTransformWrapper(torch.nn.Identity(),
                                                train_angle=False)
    x = torch.rand(1, 2, 8, 8, requires_grad=True)
    wrap(x).sum().backward()
    assert wrap.angle.grad is None and x.grad is not None


# ------------------------------------------------------- the 'forward' norm
def test_forward_norm_differs_from_lama_tpu_dft():
    """lama_tpu's DFT matrices scale norm='forward' as 'backward'
    (lama_tpu/ops/spectral.py:34, :45, :61): its default unit (the DFT
    path at 8x8) differs from the port's and from its own jnp.fft path,
    which the port matches."""
    x = np.random.RandomState(3).rand(1, 8, 8, 4).astype(np.float32)
    units = {}
    for dft in (None, False):
        jmod = jffc.FourierUnit(4, fft_norm='forward', use_dft_matmul=dft)
        if dft is None:
            variables = jax_variables(jmod, jnp.asarray(x), seed=10)
        units[dft] = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    port = _load(ffc.FourierUnit(4, 4, fft_norm='forward', kernels='plain'),
                 variables)
    with torch.no_grad():
        ours = nhwc(port(nchw(x)))
    np.testing.assert_allclose(ours, units[False], rtol=1e-5, atol=1e-6)
    assert np.abs(units[None] - units[False]).max() > 0.5 * np.abs(
        units[False]).max()
    assert np.abs(ours - units[None]).max() > 0.5 * np.abs(ours).max()


# ------------------------------------------------------------ int8 serving
INT8_ATOL = 1e-4   # tests/test_torch_int8.py's GEN_ATOL
INT8_GATES = dict(min_contraction_channels=8, min_out_channels=8)


def test_opt_st_outffc_int8_matches_lama_tpu():
    """chip_smoke.py's opt_st_outffc generator (two wrapped blocks and
    out_ffc) at ngf 16, int8 serving with lowered gates, against
    lama_tpu's at tests/test_torch_int8.py's bound."""
    gkw = dict(GEN_KW, ngf=16, spatial_transform_layers=[0], out_ffc=True)
    jgen = jax_make('ffc_resnet', serving_mode=JaxMode(int8=True,
                                                       **INT8_GATES), **gkw)
    x = _input(b=1, size=32, seed=6)
    variables = jax_variables(jgen, jnp.asarray(x), train=False, seed=11)
    ref = np.asarray(jax.jit(functools.partial(jgen.apply, train=False))(
        variables, jnp.asarray(x)))
    fp32 = np.asarray(jax.jit(functools.partial(
        jax_make('ffc_resnet', **gkw).apply, train=False))(
            variables, jnp.asarray(x)))
    port = port_generator(gkw, variables, serving_mode=ServingMode(
        int8=True, **INT8_GATES)).eval()
    assert sum(getattr(m, 'quantized', False) for m in port.modules()) > 0
    assert np.abs(ref - fp32).max() >= 10 * INT8_ATOL
    with torch.no_grad():
        out = nhwc(port(nchw(x)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=INT8_ATOL)


# ------------------------------------------------- the route past 256
def test_kernel_fits_at_the_envelope():
    assert fu.kernel_fits(256, 256) and fu.kernel_fits(1, 256)
    assert not fu.kernel_fits(257, 8) and not fu.kernel_fits(8, 257)
    assert fu.stores_bf16(torch.zeros(1, 1, 256, 256, dtype=torch.bfloat16),
                          True)
    assert not fu.stores_bf16(
        torch.zeros(1, 1, 257, 8, dtype=torch.bfloat16), True)


@pytest.mark.parametrize('kernels', ['cuda', 'plain'])
def test_wide_unit_takes_the_fft_route(kernels, monkeypatch):
    """A unit of side 320 runs `fourier_unit_fft` (no kernel launch, no
    kernel plain version), matching lama_tpu's unit, which takes jnp.fft
    there (use_dft_matmul=None)."""
    x = np.random.RandomState(12).rand(1, 320, 320, 2).astype(np.float32)
    jmod = jffc.FourierUnit(2, fft_norm='backward')
    variables = jax_variables(jmod, jnp.asarray(x), seed=13)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    port = _load(ffc.FourierUnit(2, 2, fft_norm='backward', kernels=kernels),
                 variables)

    def refuse(*args, **kwargs):
        raise AssertionError('the kernel route past 256')
    monkeypatch.setattr(ffc, 'fused_fourier_unit', refuse)
    monkeypatch.setattr(ffc, 'fourier_unit_plain', refuse)
    before = fu.fourier_unit_fft.calls
    with torch.no_grad():
        out = nhwc(port(nchw(x)))
    assert fu.fourier_unit_fft.calls == before + 1
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
