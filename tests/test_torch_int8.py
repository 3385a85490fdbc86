"""int8 serving on the CPU: the port's quantized convs, generators and
calibration against lama_tpu's, and the int8 kernel's plan replayed in
numpy.

Conv level (the cases of tests/test_quant.py:20-64, plus a 1x1 conv and
zero_pad): lama_tpu.ops.quant's own int8 codes, int32 sums and outputs,
read off its XLA conv call, against ops/quant.py's plain version: the
codes and the sums equal, the outputs within rtol 1e-6. The generators in
int8 at fp32 compute, FFC and GlobalGenerator, reflect and zero_pad, and
the calibration (amax per conv, static = dynamic on the calibration batch,
serving with lama_tpu's stats carried across): within GEN_ATOL of
lama_tpu, which each test checks is at most a tenth of the int8-vs-fp32
difference on the same input, so a port that skipped quantizing would
fail. The kernel's plan (phases, taps, border maps, packed weights)
replayed in numpy equals the exact plain sums.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lama_tpu.ops import quant as jq
from lama_tpu.ops.serving_mode import ServingMode as JaxMode
from lama_tpu_torch.convert import (act_amax_from_flax, set_act_amax,
                                    state_dict_from_flax)
from lama_tpu_torch.models import make_generator
from lama_tpu_torch.ops import quant
from lama_tpu_torch.ops.kernels import conv_int8 as ci
from lama_tpu_torch.ops.serving_mode import ServingMode
from lama_tpu_torch.serving import calibrate_int8

torch.set_num_threads(1)

# the generators' tolerance (sigmoid outputs in [0, 1]): lama_tpu and the
# port round their fp32 sums in other orders, so a code may land one step
# apart where an activation sits on a rounding boundary (measured: at most
# 1.1e-6 on these inputs, where int8 and fp32 differ by 1.4e-2 (pix2pixhd)
# and 5.4e-2 (FFC))
GEN_ATOL = 1e-4
GATES = dict(min_contraction_channels=8, min_out_channels=8)
# the generators' kernels are the reference init's scale times WEIGHT_GAIN,
# their BN statistics random: with the init as it is, the sigmoid output
# barely leaves 0.5 and int8 moves it by 1e-4 only
WEIGHT_GAIN = 3.0


def jax_init(module, x, seed=0):
    """The variable tree of `module.init(key, x, train=False)`, filled from
    numpy (flax's init of a generator takes 10-25 s on the CPU): kernels
    uniform in +-WEIGHT_GAIN / sqrt(fan in), as the reference init's times
    WEIGHT_GAIN; biases uniform in +-0.05; BatchNorm scales 1, running
    means 0.1 N(0, 1) and running variances 1 + 0.3 U(0, 1)."""
    shapes = jax.eval_shape(functools.partial(module.init, train=False),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            a = (rng.uniform(-1, 1, shape) * WEIGHT_GAIN
                 / np.sqrt(np.prod(shape[:-1])))
        elif name == 'scale':
            a = np.ones(shape)
        elif name == 'mean':
            a = 0.1 * rng.randn(*shape)
        elif name == 'var':
            a = 1 + 0.3 * rng.rand(*shape)
        else:
            a = 0.05 * rng.uniform(-1, 1, shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _capture(monkeypatch):
    """Record lama_tpu.ops.quant's XLA conv calls: (int8 lhs as it enters
    the conv, int8 rhs, int32 sums)."""
    calls = []
    real = jax.lax.conv_general_dilated

    def conv(lhs, rhs, *args, **kwargs):
        out = real(lhs, rhs, *args, **kwargs)
        calls.append((np.asarray(lhs), np.asarray(rhs), np.asarray(out)))
        return out

    monkeypatch.setattr(jq, 'jax', types.SimpleNamespace(
        lax=types.SimpleNamespace(conv_general_dilated=conv)))
    return calls


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


@pytest.mark.parametrize('padding_mode,stride,dilation,groups,k,zero_pad', [
    ('zeros', 1, 1, 1, 3, False),
    ('reflect', 1, 1, 1, 3, False),
    ('reflect', 2, 1, 1, 3, False),
    ('zeros', 1, 2, 1, 3, False),
    ('zeros', 1, 1, 2, 3, False),
    ('zeros', 1, 1, 1, 1, False),
    ('reflect', 1, 1, 1, 3, True),
    ('reflect', 2, 1, 1, 3, True),
])
def test_quantized_conv2d_matches_lama_tpu(monkeypatch, padding_mode, stride,
                                           dilation, groups, k, zero_pad):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 64).astype(np.float32)
    w = (rng.randn(k, k, 64 // groups, 96) * 0.05).astype(np.float32)
    b = (rng.randn(96) * 0.1).astype(np.float32)
    pad = dilation * (k // 2)
    calls = _capture(monkeypatch)
    ref = np.asarray(jq.quantized_conv2d(
        jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b), stride=stride,
        padding=pad, dilation=dilation, groups=groups,
        padding_mode=padding_mode, out_dtype=jnp.float32, zero_pad=zero_pad))
    lhs, rhs, acc = calls[0]
    xt = _nchw(x)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    s_x = quant.act_scale(xt)
    xq = quant.quantize(xt, s_x)
    wq, s_w = quant.quantize_weight(wt)
    if padding_mode != 'zeros' and pad and not zero_pad:
        lhs = lhs[:, pad:-pad, pad:-pad]   # lama_tpu gathers the border
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), lhs)
    np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(), rhs)
    ours = quant.conv2d_acc(xq, wq, stride, pad, dilation, groups,
                            padding_mode, zero_pad)
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), acc)
    out = quant.quantized_conv2d(xt, wt, torch.from_numpy(b), stride, pad,
                                 dilation, groups, padding_mode,
                                 zero_pad=zero_pad)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    # the wrapper takes the plain version on a CPU tensor
    assert torch.equal(ci.quantized_conv2d(
        xt, wt, torch.from_numpy(b), stride, pad, dilation, groups,
        padding_mode, zero_pad=zero_pad), out)


@pytest.mark.parametrize('stride,padding,output_padding', [
    (2, 1, 1), (2, 0, 0), (1, 1, 0)])
def test_quantized_conv_transpose2d_matches_lama_tpu(monkeypatch, stride,
                                                     padding, output_padding):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 128).astype(np.float32)
    w = (rng.randn(3, 3, 128, 64) * 0.05).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    calls = _capture(monkeypatch)
    ref = np.asarray(jq.quantized_conv_transpose2d(
        jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b), stride=stride,
        padding=padding, output_padding=output_padding,
        out_dtype=jnp.float32))
    lhs, rhs, acc = calls[0]
    xt = _nchw(x)
    # the port's ConvTranspose2d weight is (I, O, kh, kw)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 3, 0, 1)))
    s_x = quant.act_scale(xt)
    xq = quant.quantize(xt, s_x)
    wq, _ = quant.quantize_weight(wt, transposed=True)
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), lhs)
    # lama_tpu's conv takes the kernel flipped
    np.testing.assert_array_equal(
        wq.permute(2, 3, 0, 1).flip(0, 1).numpy(), rhs)
    ours = quant.conv_transpose2d_acc(xq, wq, stride, padding,
                                      output_padding)
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), acc)
    out = quant.quantized_conv_transpose2d(xt, wt, torch.from_numpy(b),
                                           stride, padding, output_padding)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize('args', [(64, 64, 1, 3, 3), (128, 64, 2, 1, 1),
                                  (4, 64, 1, 7, 7), (64, 3, 1, 7, 7),
                                  (64, 64, 2, 3, 3), (63, 32, 1, 3, 3),
                                  (64, 31, 1, 3, 3)])
def test_conv_eligible_matches_lama_tpu(args):
    for gates in ({}, GATES):
        assert quant.conv_eligible(*args, ServingMode(**gates)) == \
            jq.conv_eligible(*args, JaxMode(**gates))


def test_serving_mode_checks_match_lama_tpu():
    for kwargs in (dict(zero_pad=True), dict(calibrating=True),
                   dict(s2d='both')):
        with pytest.raises(ValueError):
            JaxMode(**kwargs)
        with pytest.raises(ValueError):
            ServingMode(**kwargs)
    mode = ServingMode(int8=True).but(zero_pad=True)
    assert mode.zero_pad and mode.int8 and ServingMode() == ServingMode()


# ------------------------------------------------- the kernel's plan in numpy

def _border(i, n, border):
    """csrc/conv_int8.cu's border_map: the source index, or -1 for a zero."""
    inside = (i >= 0) & (i < n)
    if border == ci.BORDERS['reflect']:
        return np.where(i < 0, -i, np.where(i >= n, 2 * n - 2 - i, i))
    if border == ci.BORDERS['replicate']:
        return np.clip(i, 0, n - 1)
    return np.where(inside, i, -1)


def _replay(xq, packed, plan, co):
    """The kernel's sums from its plan: codes (B, C, H, W) laid out (B, H,
    W, Cp) with zeros past C; per phase and tap, every output pixel's
    source pixel through the border map, its Cp codes times the packed
    weight slice; each phase's outputs scattered to (hg * ostride + oy0, wg
    * ostride + ox0). Every output is written once."""
    b, c, h, w = xq.shape
    cp = packed.shape[2]
    x = np.zeros((b, h, w, cp), np.int64)
    x[..., :c] = xq.permute(0, 2, 3, 1).numpy()
    wp = packed.numpy().astype(np.int64)
    out = np.full((b, plan.ho, plan.wo, co), np.iinfo(np.int64).min)
    for ph in plan.phases:
        acc = np.zeros((b, ph.hg, ph.wg, wp.shape[1]), np.int64)
        for dy, dx, wt in ph.taps:
            iy = _border(np.arange(ph.hg) * plan.stride + dy, h, plan.border)
            ix = _border(np.arange(ph.wg) * plan.stride + dx, w, plan.border)
            live = (iy >= 0)[:, None] & (ix >= 0)[None, :]
            g = x[:, np.maximum(iy, 0)][:, :, np.maximum(ix, 0)]
            acc += (g * live[None, :, :, None]) @ wp[wt].T
        ys = np.arange(ph.hg) * plan.ostride + ph.oy0
        xs = np.arange(ph.wg) * plan.ostride + ph.ox0
        target = out[:, ys][:, :, xs]
        assert (target == np.iinfo(np.int64).min).all()   # written once
        out[np.ix_(np.arange(b), ys, xs)] = acc[..., :co]
    assert (out != np.iinfo(np.int64).min).all()
    return torch.from_numpy(out).permute(0, 3, 1, 2)


@pytest.mark.parametrize('b,c,co,h,w,k,stride,mode,zero_pad', [
    (2, 40, 72, 9, 7, 3, 1, 'reflect', False),
    (1, 64, 130, 11, 10, 3, 2, 'reflect', False),
    (1, 32, 48, 7, 6, 3, 1, 'reflect', True),
    (1, 64, 40, 12, 9, 3, 2, 'zeros', False),
    (1, 24, 16, 6, 5, 3, 1, 'replicate', False),
    (2, 96, 40, 5, 5, 1, 1, 'zeros', False)])
def test_int8_plan_replay_matches_plain(b, c, co, h, w, k, stride, mode,
                                        zero_pad):
    g = torch.Generator().manual_seed(c + co)
    x = torch.rand(b, c, h, w, generator=g) * 2 - 1
    weight = torch.rand(co, c, k, k, generator=g) - 0.5
    xq = quant.quantize(x, quant.act_scale(x))
    packed, s_w = ci.pack_weight(weight)
    wq, s_ref = quant.quantize_weight(weight)
    assert torch.equal(s_w, s_ref)
    # the packed layout: (tap ky * k + kx, C_out padded, C padded), zeros
    # in the padding
    assert packed.shape == (k * k, ci.round_up(co, ci.COP_ALIGN),
                            ci.round_up(c, ci.CHUNK))
    assert torch.equal(packed[:, :co, :c],
                       wq.permute(2, 3, 0, 1).reshape(k * k, co, c))
    assert not packed[:, co:].any() and not packed[:, :, c:].any()
    plan = ci.conv_plan(x.shape, weight.shape, stride, k // 2, 1, 1, mode,
                        zero_pad)
    ref = quant.conv2d_acc(xq, wq, stride, k // 2, 1, 1, mode, zero_pad)
    assert torch.equal(_replay(xq, packed, plan, co), ref.long())


@pytest.mark.parametrize('c,co,h,w,stride,d,mode,zero_pad', [
    (40, 72, 12, 11, 1, 2, 'reflect', False),
    (32, 48, 12, 10, 1, 8, 'reflect', False),
    (32, 48, 12, 10, 1, 8, 'reflect', True),
    (24, 40, 11, 9, 1, 2, 'zeros', False),
    (24, 40, 13, 12, 1, 8, 'zeros', False),
    (64, 40, 12, 9, 2, 2, 'reflect', False),
    (24, 16, 9, 7, 1, 4, 'replicate', False)])
def test_int8_dilated_plan_replay_matches_plain(c, co, h, w, stride, d, mode,
                                                zero_pad):
    """The multidilated branches' convs (3x3, pad = dilation): the plan
    replayed in numpy equals the exact plain sums at dilations 2, 4 and 8,
    with reflect, zero and replicate borders, zero_pad and stride 2."""
    g = torch.Generator().manual_seed(c + co + d)
    x = torch.rand(2, c, h, w, generator=g) * 2 - 1
    weight = torch.rand(co, c, 3, 3, generator=g) - 0.5
    xq = quant.quantize(x, quant.act_scale(x))
    packed, _ = ci.pack_weight(weight)
    wq, _ = quant.quantize_weight(weight)
    plan = ci.conv_plan(x.shape, weight.shape, stride, d, d, 1, mode,
                        zero_pad)
    ref = quant.conv2d_acc(xq, wq, stride, d, d, 1, mode, zero_pad)
    assert (plan.ho, plan.wo) == tuple(ref.shape[2:])
    assert torch.equal(_replay(xq, packed, plan, co), ref.long())


@pytest.mark.parametrize('stride,padding,output_padding,taps', [
    (2, 1, 1, [1, 2, 2, 4]), (2, 0, 0, [4, 2, 2, 1]), (1, 1, 0, [9])])
def test_int8_transposed_phases_replay_matches_plain(stride, padding,
                                                     output_padding, taps):
    """big-lama's ConvTranspose (k3 s2 p1 op1) is four output phases of 1,
    2, 2 and 4 taps over the undilated input; every output pixel belongs
    to one phase."""
    g = torch.Generator().manual_seed(stride + padding)
    x = torch.rand(2, 48, 6, 5, generator=g) * 2 - 1
    weight = torch.rand(48, 20, 3, 3, generator=g) - 0.5
    xq = quant.quantize(x, quant.act_scale(x))
    packed, _ = ci.pack_weight(weight, transposed=True)
    wq, _ = quant.quantize_weight(weight, transposed=True)
    plan = ci.conv_transpose_plan(x.shape, weight.shape, stride, padding,
                                  output_padding)
    assert [len(p.taps) for p in plan.phases] == taps
    ref = quant.conv_transpose2d_acc(xq, wq, stride, padding, output_padding)
    assert (plan.ho, plan.wo) == tuple(ref.shape[2:])
    assert torch.equal(_replay(xq, packed, plan, 20), ref.long())


def test_int8_plan_refuses_what_the_kernel_does_not_take():
    """Grouped convs and more than 9 taps stay refused; a dilated conv is
    planned (its taps d apart, the output size of torch's formula), and a
    reflect pad must stay below the side at any dilation."""
    shape = (1, 64, 8, 8)
    with pytest.raises(NotImplementedError, match='ungrouped'):
        ci.conv_plan(shape, (64, 64, 3, 3), 1, 1, groups=2)
    with pytest.raises(NotImplementedError, match='ungrouped'):
        ci.conv_plan(shape, (64, 64, 5, 5), 1, 2)
    plan = ci.conv_plan(shape, (64, 64, 3, 3), 1, 2, dilation=2,
                        padding_mode='reflect')
    assert (plan.ho, plan.wo) == (8, 8)
    assert [t[:2] for t in plan.phases[0].taps][:3] == [(-2, -2), (-2, 0),
                                                        (-2, 2)]
    with pytest.raises(ValueError, match='reflect padding'):
        ci.conv_plan(shape, (64, 64, 3, 3), 1, 8, dilation=8,
                     padding_mode='reflect')
    assert ci.tile_n(192) == 192 and ci.tile_n(384) == 192
    assert ci.tile_n(64) == 64 and ci.tile_n(512) == 128
    assert ci.tile_n(128) == 128 and ci.tile_n(288) == 64


def test_int8_source_matches_its_plan():
    """csrc/conv_int8.cu's constants and structures are the wrapper's; it
    quantizes by a division and rint (round half to even, as torch.round;
    roundf rounds half away from zero), and its products are int8 wgmma
    (m64nNk32, s8 x s8 -> s32, one instance a tile width) from shared
    memory, with no mma.sync or ldmatrix left."""
    import re
    from lama_tpu_torch.ops.kernels import _build
    with open(_build.source_path('conv_int8')) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+)', src).group(1))

    for name in ('THREADS', 'BM', 'CHUNK', 'KCH', 'GROUP', 'STAGES',
                 'COP_ALIGN', 'MAX_TAPS', 'MAX_PHASES'):
        assert const(name) == getattr(ci, name), name
    assert re.findall(r'if \(bn == (\d+)\) return launch_conv', src) == [
        str(n) for n in ci.TILE_N]
    for kind, value in ci.BORDERS.items():
        name = {'zeros': 'ZERO'}.get(kind, kind.upper())
        assert f'BORDER_{name} = {value}' in src
    for kind, value in (('FP32', 0), ('BF16', 1), ('ACC', 2)):
        assert f'OUT_{kind} = {value}' in src

    def fields(struct):
        body = src[src.index(f'struct {struct} {{'):]
        body = re.sub(r'//.*', '', body[:body.index('};')]).split('{', 1)[1]
        out = []
        for decl in body.split(';'):
            if decl.strip():
                out += [re.findall(r'\w+', v.split('[')[0])[-1]
                        for v in decl.split(',')]
        return out

    assert fields('Int8Phase') == [f for f, _ in ci._Phase._fields_]
    assert fields('Int8ConvArgs') == [f for f, _ in ci._Args._fields_]
    code = re.sub(r'//.*', '', src)
    assert 'roundf' not in code and 'rintf(__fdiv_rn(' in code
    assert 'mma.sync' not in code and 'ldmatrix' not in code
    assert re.findall(r'wgmma\.mma_async\.sync\.aligned\.m64n(\d+)k32'
                      r'\.s32\.s8\.s8 ', code) == [
        str(n) for n in sorted(ci.TILE_N, reverse=True)]
    assert '__fmul_rn(s_x, p.s_w[n])' in code
    assert '__fmul_rn(__int2float_rn(a[e]), col_scale[8 * v + e])' in code
    assert '__fadd_rn(f[e], col_bias[8 * v + e])' in code


# ----------------------------------------------------------- the generators

FFC_KW = dict(input_nc=4, output_nc=3, ngf=16, n_downsampling=2, n_blocks=1,
              add_out_act='sigmoid',
              init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0,
                                    enable_lfu=False),
              downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0,
                                          enable_lfu=False),
              resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75,
                                      enable_lfu=False))
GG_KW = dict(input_nc=4, output_nc=3, ngf=8, n_downsampling=2, n_blocks=1,
             add_out_act='sigmoid')
# configs/training/ablv2_work_md.yaml's blocks (cat_in, dilations 1, 2, 4,
# 8) at 48^2: the 12^2 bottleneck keeps the dilation-8 reflect pad of 8
# below its side
MD_KW = dict(GG_KW, multidilation_kwargs=dict(comb_mode='cat_in',
                                                      dilation_num=4))
FAMILIES = {'ffc_resnet': (FFC_KW, 32), 'pix2pixhd_global': (GG_KW, 32),
            'pix2pixhd_multidilated': (MD_KW, 48)}


def _inputs(seed=0, size=32):
    rng = np.random.RandomState(seed)
    img = rng.rand(1, size, size, 3).astype(np.float32)
    mask = np.zeros((1, size, size, 1), np.float32)
    mask[:, size // 4:3 * size // 4, size // 4:3 * size // 4] = 1.0
    x = np.concatenate([img * (1 - mask), mask], axis=-1)
    return img, mask, x


def _apply(module, variables, x):
    """lama_tpu's eval forward, jitted (op by op it takes 5-10 s here)."""
    return np.asarray(jax.jit(functools.partial(module.apply, train=False))(
        variables, jnp.asarray(x)))


@pytest.fixture(scope='module', params=sorted(FAMILIES))
def family(request):
    """lama_tpu's generator of one family in int8 (lowered gates) and its
    variables, the port's in int8 with those weights, an input, and the
    int8-vs-fp32 difference of lama_tpu's output on it."""
    from lama_tpu.models import make_generator as jax_make
    kind = request.param
    kw, size = FAMILIES[kind]
    jmode = JaxMode(int8=True, **GATES)
    jgen = jax_make(kind, serving_mode=jmode, **kw)
    img, mask, x = _inputs(size=size)
    variables = jax_init(jgen, x, seed=3)
    fp32 = _apply(jax_make(kind, **kw), variables, x)
    ref = _apply(jgen, variables, x)
    sd = state_dict_from_flax(variables, kw['n_downsampling'], kw['n_blocks'],
                              kind=kind)

    def port(mode=ServingMode(int8=True, **GATES)):
        g = make_generator(kind, serving_mode=mode, **kw)
        g.load_state_dict(sd, strict=True)
        return g.eval()

    return types.SimpleNamespace(kind=kind, kw=kw, size=size, jgen=jgen,
                                 jmode=jmode,
                                 variables=variables, img=img, mask=mask,
                                 x=x, ref=ref, int8_vs_fp32=float(
                                     np.abs(ref - fp32).max()), port=port)


def _run(gen, x):
    with torch.no_grad():
        return gen(_nchw(x)).permute(0, 2, 3, 1).numpy()


def test_int8_generator_matches_lama_tpu(family):
    gen = family.port()
    assert sum(getattr(m, 'quantized', False) for m in gen.modules()) > 0
    assert GEN_ATOL <= family.int8_vs_fp32 / 10, family.int8_vs_fp32
    np.testing.assert_allclose(_run(gen, family.x), family.ref, rtol=0,
                               atol=GEN_ATOL)


def test_int8_zero_pad_generator_matches_lama_tpu(family):
    from lama_tpu.models import make_generator as jax_make
    jgen = jax_make(family.kind, serving_mode=family.jmode.but(zero_pad=True),
                    **family.kw)
    ref = _apply(jgen, family.variables, family.x)
    assert np.abs(ref - family.ref).max() > 0    # the border differs
    ours = _run(family.port(ServingMode(int8=True, zero_pad=True, **GATES)),
                family.x)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=GEN_ATOL)


def test_calibration_matches_lama_tpu(family):
    from lama_tpu.serving import calibrate_int8 as jax_calibrate
    calibrated = jax_calibrate(family.jgen, family.variables,
                               [(family.img, family.mask)])
    stats = act_amax_from_flax(calibrated)
    gen = family.port()
    dynamic = _run(gen, family.x)
    calibrate_int8(gen, [(family.img, family.mask)])
    ours = {f'{n}.act_amax': m.act_amax for n, m in gen.named_modules()
            if getattr(m, 'quantized', False)}
    assert sorted(ours) == sorted(stats) and ours
    for key, val in stats.items():
        np.testing.assert_allclose(float(ours[key]), float(val), rtol=1e-6)
    # static scales from the calibration batch = its dynamic scales
    assert np.array_equal(_run(gen, family.x), dynamic)
    # serving with lama_tpu's stats carried across = lama_tpu's static serve
    served = family.port()
    set_act_amax(served, stats)
    # with the calibration input, one that saturates where it exceeds the
    # stats (static scales: each image's output is its own in a batch)
    both = np.concatenate([family.x, _inputs(seed=1, size=family.size)[2]])
    np.testing.assert_allclose(_run(served, both),
                               _apply(family.jgen, calibrated, both), rtol=0,
                               atol=GEN_ATOL)


def test_calibrate_int8_refuses_without_int8_or_batches(family):
    with pytest.raises(ValueError, match='int8'):
        calibrate_int8(make_generator(family.kind, **family.kw), [])
    with pytest.raises(ValueError, match='batches'):
        calibrate_int8(family.port(), [])
    with pytest.raises(KeyError):
        set_act_amax(family.port(), {'model.1.act_amax': torch.tensor(1.0)})


@pytest.mark.parametrize('config,count', [('big-lama', 187),
                                          ('big-lama-regular', 42)])
def test_int8_convs_at_full_width(config, count):
    """The shipped configs at full width (built, not run): big-lama's int8
    convs are its 4 downsamples, 108 3x3 FFC convs (l2l, l2g, g2l in 36
    layers), 72 SpectralTransform 1x1 convs and 3 ConvTranspose layers;
    big-lama-regular's its 3 downsamples, 36 block convs and 3
    ConvTranspose layers. The stem (4 input channels) and the head (3
    outputs) and every FourierUnit's spectral conv stay out."""
    import os
    from lama_tpu_torch.serving import generator_config
    kw = generator_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'configs', 'training', config + '.yaml'))
    gen = make_generator(kw.pop('kind'), serving_mode=ServingMode(int8=True),
                         **kw)
    quantized = [n for n, m in gen.named_modules()
                 if getattr(m, 'quantized', False)]
    assert len(quantized) == count
    assert not any(n in ('model.1', 'model.1.ffc.convl2l')
                   or n.endswith('conv_layer') for n in quantized)
