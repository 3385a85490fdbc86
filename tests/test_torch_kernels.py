"""The port's kernel modules against the JAX package's Pallas kernels.

Each kernel's plain PyTorch version (the path its wrapper takes on a CPU
tensor) is held against the TPU kernel run in Pallas interpret mode on the
same numpy inputs, at small envelope shapes, rtol 1e-4 / atol 1e-5 (fp32;
the two differ only in summation order). The FourierUnit kernel's stage
plan (shapes, strides, twiddle tables) is replayed in numpy and held against
the plain version, which covers what the CUDA source takes from Python. The
CUDA sources themselves build and run only on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lama_tpu.ops.pallas import fourier_unit as jfu
from lama_tpu.ops.pallas import reflect_conv as jrc
from lama_tpu_torch.ops.kernels import _autograd, _build
from lama_tpu_torch.ops.kernels import fourier_unit as tfu
from lama_tpu_torch.ops.kernels import reflect_conv as trc

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


CONV_CASES = [
    # (kernel name, (B, H, W, C), C_out, bias)
    ('reflect_conv3x3_cols', (2, 16, 16, 128), 128, False),
    ('reflect_conv3x3_cols', (2, 16, 16, 128), 128, True),
    ('reflect_conv3x3_taps', (2, 16, 16, 384), 128, False),
    ('reflect_conv3x3_taps', (2, 16, 16, 128), 384, False),
    ('reflect_out_conv7x7', (2, 16, 16, 64), 3, True),
    ('reflect_down_conv3x3', (2, 16, 16, 64), 128, False),
    ('reflect_down_conv3x3', (2, 16, 16, 64), 128, True),
    # fp32 cols and taps at an odd bottleneck (partial tiles on both sides)
    ('reflect_conv3x3_cols', (1, 13, 11, 128), 128, False),
    ('reflect_conv3x3_taps', (1, 13, 11, 384), 128, False),
    ('reflect_conv3x3_taps', (1, 13, 11, 128), 384, True),
]


@pytest.mark.parametrize('name,shape,c_out,use_bias', CONV_CASES)
def test_reflect_conv_plain_matches_pallas_interpret(name, shape, c_out,
                                                      use_bias):
    rng = np.random.RandomState(0)
    k = 7 if '7x7' in name else 3
    x = rng.rand(*shape).astype(np.float32)
    kern = (rng.randn(k, k, shape[-1], c_out) * 0.05).astype(np.float32)
    bias = rng.randn(c_out).astype(np.float32) if use_bias else None
    ref = getattr(jrc, name)(jnp.asarray(x), jnp.asarray(kern),
                             bias=None if bias is None else jnp.asarray(bias),
                             dtype=jnp.float32, interpret=True)
    weight = torch.from_numpy(np.ascontiguousarray(
        np.transpose(kern, (3, 2, 0, 1))))
    before = getattr(trc, name).launches
    out = getattr(trc, name)(_nchw(x), weight,
                             None if bias is None else torch.from_numpy(bias))
    assert getattr(trc, name).launches == before   # CPU: plain, no launch
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('k,s,h,w,c,co', [
    (3, 1, 32, 128, 8, 16),
    (3, 2, 64, 128, 8, 16),
    (7, 1, 32, 128, 8, 16),
])
def test_halo_conv_plain_matches_pallas_interpret(k, s, h, w, c, co):
    """Kernel 7's plain version (its wrapper on a CPU tensor) against
    halo_conv_reflect_tiled in interpret mode, in the TPU envelope."""
    from lama_tpu.ops.pallas import halo_conv as jhc
    from lama_tpu_torch.ops.kernels import halo_conv as thc
    rng = np.random.RandomState(k + s)
    x = rng.randn(1, h, w, c).astype(np.float32)
    kern = (rng.randn(k, k, c, co) * 0.1).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    ref = jhc.halo_conv_reflect_tiled(jnp.asarray(x), jnp.asarray(kern),
                                      bias=jnp.asarray(bias), stride=s,
                                      dtype=jnp.float32, interpret=True)
    weight = torch.from_numpy(np.ascontiguousarray(
        np.transpose(kern, (3, 2, 0, 1))))
    before = thc.halo_conv_reflect_tiled.launches
    out = thc.halo_conv_reflect_tiled(_nchw(x), weight, torch.from_numpy(bias),
                                      stride=s)
    assert thc.halo_conv_reflect_tiled.launches == before   # CPU: plain
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=RTOL,
                               atol=1e-4)


def test_halo_conv_envelope_drops_the_tpu_tiling():
    """Every TPU-envelope shape is in the port's; the stem (C = 4) and odd
    sides, outside the TPU's C % 8, W % 128 and H % (16 s), are in it too."""
    from lama_tpu.ops.pallas import halo_conv as jhc
    from lama_tpu_torch.ops.kernels import halo_conv as thc
    for k, s, h, w, c, co in [(3, 1, 32, 128, 8, 16), (7, 2, 64, 256, 16, 8)]:
        assert jhc.halo_conv_reflect_tiled_supported(h, w, c, co, k, s)
        assert thc.halo_conv_reflect_tiled_supported(h, w, c, co, k, s)
    assert not jhc.halo_conv_reflect_tiled_supported(512, 512, 4, 64, 7, 1)
    assert thc.halo_conv_reflect_tiled_supported(512, 512, 4, 64, 7, 1)
    assert thc.halo_conv_reflect_tiled_supported(1000, 761, 4, 64, 7, 1)
    assert not thc.halo_conv_reflect_tiled_supported(3, 64, 4, 64, 7, 1)
    assert not thc.halo_conv_reflect_tiled_supported(64, 64, 4, 64, 5, 1)


@pytest.mark.parametrize('b,h,w,c,co', [(2, 16, 16, 8, 8), (1, 12, 20, 24, 40),
                                        (2, 16, 16, 64, 64)])
def test_halo_conv3x3_plain_matches_pallas_interpret(b, h, w, c, co):
    """Kernel 6's plain version (its wrapper on a CPU tensor) against
    halo_conv3x3_reflect's kernel body in interpret mode (the wrapper has
    no interpret argument: the pallas_call of halo_conv.py:61-76, as
    tests/test_pallas_kernel.py runs it), the bias added after it as
    halo_conv.py:77-78 does."""
    import functools

    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from lama_tpu.ops.pallas import halo_conv as jhc
    from lama_tpu_torch.ops.kernels import halo_conv as thc
    rng = np.random.RandomState(c + co)
    x = rng.rand(b, h, w, c).astype(np.float32)
    kern = (rng.randn(3, 3, c, co) * 0.1).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    ref = pl.pallas_call(
        functools.partial(jhc._kernel, dtype=jnp.float32),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, h, w, co), lambda i: (i, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, h, w, co), jnp.float32),
        interpret=True)(jnp.asarray(x), jnp.asarray(kern))
    ref = np.asarray(ref + jnp.asarray(bias).reshape((1, 1, 1, -1)))
    weight = torch.from_numpy(np.ascontiguousarray(
        np.transpose(kern, (3, 2, 0, 1))))
    before = thc.halo_conv3x3_reflect.launches
    out = thc.halo_conv3x3_reflect(_nchw(x), weight, torch.from_numpy(bias))
    assert thc.halo_conv3x3_reflect.launches == before   # CPU: plain
    np.testing.assert_allclose(_nhwc(out), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        _nhwc(thc.halo_conv3x3_reflect_plain(_nchw(x), weight,
                                             torch.from_numpy(bias))),
        ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('h,w,c,co', [(32, 32, 512, 512), (16, 16, 8, 8),
                                      (12, 20, 24, 40), (64, 64, 128, 128),
                                      (8, 8, 1024, 256)])
def test_halo_conv3x3_envelope_drops_the_vmem_budget(h, w, c, co):
    """Every shape in the TPU kernel's envelope (its VMEM budget) is in
    the port's; serving's (64, 64, 512, 512) is in the port's only, and
    the port's lower bound is torch's reflect pad of 1 (H, W >= 2)."""
    from lama_tpu.ops.pallas import halo_conv as jhc
    from lama_tpu_torch.ops.kernels import halo_conv as thc
    assert jhc.halo_conv3x3_supported(h, w, c, co)
    assert thc.halo_conv3x3_reflect_supported(h, w, c, co)
    assert not jhc.halo_conv3x3_supported(64, 64, 512, 512)
    assert thc.halo_conv3x3_reflect_supported(64, 64, 512, 512)
    assert thc.halo_conv3x3_reflect_supported(2, 2, 1, 1)
    assert not thc.halo_conv3x3_reflect_supported(1, 64, 8, 8)
    assert not thc.halo_conv3x3_reflect_supported(64, 64, 0, 8)


def test_stem_dispatches_to_the_tiled_halo_conv():
    """ops/conv.py sends the 7x7 4 -> 64 stem and 3x3 stride-2 convs
    outside kernel 4's envelope to kernel 7, keeps kernels 2-5 on their
    shapes, and sends every other 3x3 stride-1 reflect conv (the
    GlobalGenerator's 512 -> 512, the tiny widths) to kernel 6."""
    from lama_tpu_torch.ops import conv
    from lama_tpu_torch.ops.kernels import halo_conv as thc

    def pick(c, co, h, k, s):
        x = torch.empty(1, c, h, h)
        return conv.kernel_for(x, torch.empty(co, c, k, k), s, k // 2, 1, 1,
                               'reflect')

    stem = pick(4, 64, 256, 7, 1)
    assert stem.func is thc.halo_conv_reflect_tiled and stem.keywords == {'stride': 1}
    small_down = pick(8, 16, 64, 3, 2)
    assert small_down.func is thc.halo_conv_reflect_tiled
    assert small_down.keywords == {'stride': 2}
    assert pick(64, 128, 64, 3, 2) is trc.reflect_down_conv3x3
    assert pick(64, 3, 64, 7, 1) is trc.reflect_out_conv7x7
    assert pick(128, 128, 64, 3, 1) is trc.reflect_conv3x3_cols
    assert pick(128, 384, 64, 3, 1) is trc.reflect_conv3x3_taps
    assert pick(8, 16, 64, 3, 1) is thc.halo_conv3x3_reflect
    assert pick(512, 512, 64, 3, 1) is thc.halo_conv3x3_reflect
    assert pick(256, 256, 32, 3, 1) is thc.halo_conv3x3_reflect
    assert pick(8, 8, 1, 3, 1) is None   # below torch's reflect pad of 1
    assert conv.kernel_for(torch.empty(1, 4, 64, 64), torch.empty(64, 4, 7, 7),
                           1, 3, 1, 1, 'zeros') is None


@pytest.mark.parametrize('h,w,c,c_out', [(64, 64, 128, 128), (64, 64, 384, 128),
                                         (64, 64, 128, 384), (64, 48, 128, 128),
                                         (64, 64, 192, 128), (512, 512, 64, 3)])
def test_envelopes_follow_the_tpu_kernels(h, w, c, c_out):
    for name in ('reflect_conv3x3_cols', 'reflect_conv3x3_taps'):
        ours = getattr(trc, name + '_supported')(h, w, c, c_out)
        assert ours == getattr(jrc, name + '_supported')(h, w, c, c_out)
    # the head drops only the TPU's row-tile divisibility (h % 128)
    assert (trc.reflect_out_conv7x7_supported(h, w, c, c_out)
            == jrc.reflect_out_conv7x7_supported(h, w, c, c_out))


def _fu_params(rng, c, co):
    return dict(conv=(rng.randn(2 * co, 2 * c, 1, 1) * 0.3).astype(np.float32),
                gamma=(rng.rand(2 * co) + 0.5).astype(np.float32),
                beta=rng.randn(2 * co).astype(np.float32),
                mean=(rng.randn(2 * co) * 0.1).astype(np.float32),
                var=(rng.rand(2 * co) + 0.5).astype(np.float32))


def _torch_fu_args(p):
    return [torch.from_numpy(p[k]) for k in ('conv', 'gamma', 'beta', 'mean',
                                             'var')]


@pytest.mark.parametrize('norm', [None, 'ortho', 'backward'])
def test_fourier_unit_plain_matches_pallas_interpret(norm):
    """Each norm the TPU kernel scales as torch.fft does (None: the
    default, ortho); its 'forward' is lama_tpu's 'backward' and is not
    held to it (tests/test_torch_ffc_options.py pins that)."""
    rng = np.random.RandomState(0)
    x = rng.rand(2, 16, 16, 8).astype(np.float32)
    p = _fu_params(rng, 8, 8)
    kw = {} if norm is None else dict(norm=norm)
    ref = jfu.fused_fourier_unit(
        jnp.asarray(x), jnp.asarray(np.transpose(p['conv'], (2, 3, 1, 0))),
        jnp.asarray(p['gamma']), jnp.asarray(p['beta']),
        jnp.asarray(p['mean']), jnp.asarray(p['var']),
        dtype=jnp.float32, interpret=True, **kw)
    before = tfu.fused_fourier_unit.launches
    out = tfu.fused_fourier_unit(_nchw(x), *_torch_fu_args(p), **kw)
    assert tfu.fused_fourier_unit.launches == before
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_planar_params_match_jax():
    rng = np.random.RandomState(1)
    p = _fu_params(rng, 6, 4)
    w_ref, b_ref = jfu._planar_params(np.transpose(p['conv'], (2, 3, 1, 0)),
                                      p['gamma'], p['beta'], p['mean'],
                                      p['var'])
    w, b = tfu.planar_params(*_torch_fu_args(p))
    np.testing.assert_allclose(w.numpy(), w_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), b_ref, rtol=1e-6, atol=1e-6)
    assert tfu.planar_perm(6).tolist() == jfu._planar_perm(6).tolist()


def _index(split, i):
    d, hi, lo = split
    return (i // d) * hi + (i % d) * lo


def _replay_plan(plan, bufs):
    """numpy model of csrc/fourier_unit.cu::fu_gemm_kernel over a stage
    plan: each stage's M x N outputs in whole BM x BN tiles and its K in
    whole BK chunks, the operands gathered through their splits with zeros
    past M, N and K (as the copies' source sizes fill them), the sums in
    float64, the epilogue (bias, ReLU), the stores masked at the edges,
    then the W-DFT's zero rows, stored by the first row of tiles. Every
    element read lies in its buffer, and every store address is written
    once per stage."""
    for st in plan:
        m, n, k, bm = st['M'], st['N'], st['K'], st['bm']
        bn = tfu.tile_cols(bm)
        mp, np_, kp = (-(-m // bm) * bm, -(-n // bn) * bn,
                       -(-k // tfu.BK) * tfu.BK)

        def take(spec, n_rows, n_cols, rows_p, cols_p):
            name, row, col, _ = spec
            flat = bufs[name].reshape(-1)
            r, c = np.arange(rows_p), np.arange(cols_p)
            idx = _index(row, r)[:, None] + _index(col, c)[None, :]
            live = (r < n_rows)[:, None] & (c < n_cols)[None, :]
            assert 0 <= idx[live].min() and idx[live].max() < flat.size
            return np.where(live, flat[np.where(live, idx, 0)],
                            0).astype(np.float64)

        a, bm_ = take(st['a'], m, k, mp, kp), take(st['b'], k, n, kp, np_)
        # split i sums the stages [i chunks / s, (i + 1) chunks / s); the
        # partial sums are added in the split order
        chunks, s = kp // tfu.BK, st['splits']
        acc = 0.0
        for i in range(s):
            ks = slice(i * chunks // s * tfu.BK, (i + 1) * chunks // s * tfu.BK)
            assert ks.start < ks.stop
            acc = acc + a[:, ks] @ bm_[ks]
        if st['bias']:
            acc[:, :n] += bufs['bp'][None, :]
        if st['relu']:
            acc = np.maximum(acc, 0.0)
        z = st['zero_rows']
        assert z <= min(bm // 8, tfu.MAX_ZERO_ROWS)   # a row group each
        name, row, col, _ = st['out']
        flat = bufs[name].reshape(-1)
        idx = (_index(row, np.arange(m + z))[:, None]
               + _index(col, np.arange(n))[None, :])
        assert np.unique(idx).size == idx.size and idx.max() < flat.size
        flat[idx] = np.concatenate([acc[:m, :n], np.zeros((z, n))])


def _runs_ok(row, col, n_rows, n_cols, ev):
    """Whether every run of ev columns from a multiple of ev holds
    consecutive addresses (one split segment) and starts at a multiple of
    ev elements, on every row: what an operand's 16-byte copies need."""
    offs = _index(col, np.arange(n_cols))
    starts = np.arange(0, n_cols, ev)
    for e in range(1, ev):
        s = starts[starts + e < n_cols]
        if not np.array_equal(offs[s + e], offs[s] + e):
            return False
    return not ((offs[starts] % ev).any()
                or (_index(row, np.arange(n_rows)) % ev).any())


def _operands(st, x_bf16):
    """(key, spec, rows, columns, elements a 16-byte run) of a stage."""
    for key, n_rows, n_cols in (('a', st['M'], st['K']),
                                ('b', st['K'], st['N']),
                                ('out', st['M'] + st['zero_rows'], st['N'])):
        yield (key, st[key], n_rows, n_cols,
               8 if x_bf16 and st[key][0] == 'x' else 4)


def _replay_unit(b, h, w, c, co, x_bf16=False, pad=True, seed=2, sms=0,
                 norm='ortho'):
    """The plan replayed on numpy inputs made from `seed` with the twiddle
    tables of `norm`; the spectra and the output start as NaN, so a read
    of an element no stage wrote shows. Returns (replayed output NHWC,
    plain output NHWC)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, h, w, c).astype(np.float32)
    p = _fu_params(rng, c, co)
    wp, bp = tfu.planar_params(*_torch_fu_args(p))
    wf = w // 2 + 1
    scratch = b * h * 2 * wf * max(c, co)
    tables = tfu.twiddles_np(h, w, pad, norm)
    # the kernel reads raw row-major memory, as the replay's reshape(-1) does
    assert all(t.flags.c_contiguous for t in tables.values())
    bufs = dict(tables, x=x, wp=wp.numpy(), bp=bp.numpy(),
                s0=np.full(scratch, np.nan, np.float32),
                s1=np.full(scratch, np.nan, np.float32),
                out=np.full((b, h, w, co), np.nan, np.float32))
    _replay_plan(tfu._stage_plan(b, h, w, c, co, x_bf16, pad, sms), bufs)
    ref = tfu.fourier_unit_plain(_nchw(x), *_torch_fu_args(p), norm=norm)
    return bufs['out'], _nhwc(ref)


@pytest.mark.parametrize('b,h,w,c,co,x_bf16', [
    (2, 8, 8, 3, 3, False), (1, 6, 10, 4, 2, False), (1, 7, 5, 3, 2, False),
    (2, 9, 6, 2, 3, False),
    # odd H and W, C % 4 == 0 (16-byte runs) with an odd C'
    (2, 11, 13, 8, 5, False), (1, 13, 7, 16, 16, True),
    # C % 4 != 0 on both sides; bf16 x with C % 8 != 0
    (1, 6, 9, 6, 10, False), (2, 5, 12, 12, 4, True),
    # W whose 2 Wf and W are not multiples of the tile (M = W = 20 on
    # BM = 32 tiles, K = 130 in 9 chunks of 16), several tiles per stage
    (1, 4, 20, 8, 8, False), (1, 3, 130, 2, 2, False),
    (2, 24, 30, 16, 16, True)])
def test_fourier_unit_stage_plan_matches_plain(b, h, w, c, co, x_bf16):
    out, ref = _replay_unit(b, h, w, c, co, x_bf16)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    # on a 3-SM card these grids split K
    out, ref = _replay_unit(b, h, w, c, co, x_bf16, sms=3)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    # an operand takes 16-byte copies only where its runs allow them
    for st in tfu._stage_plan(b, h, w, c, co, x_bf16):
        for key, (_, row, col, vec), n_rows, n_cols, ev in _operands(
                st, x_bf16):
            assert not vec or _runs_ok(row, col, n_rows, n_cols, ev), key


@pytest.mark.parametrize('norm', ['backward', 'forward'])
@pytest.mark.parametrize('b,h,w,c,co,x_bf16', [
    (2, 8, 8, 3, 3, False), (1, 7, 5, 3, 2, False), (2, 11, 13, 8, 5, True)])
def test_fourier_unit_stage_plan_matches_plain_for_norm(b, h, w, c, co,
                                                        x_bf16, norm):
    """The other norms change only the tables: the same plan on the
    'backward' and 'forward' tables matches the plain unit of that norm
    (whose outputs differ from the ortho unit's)."""
    out, ref = _replay_unit(b, h, w, c, co, x_bf16, norm=norm)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    _, ortho = _replay_unit(b, h, w, c, co, x_bf16)
    assert np.abs(ref - ortho).max() > 10 * ATOL


def test_fourier_unit_tables_scale_by_norm():
    """Forward tables scale by 1/sqrt(n) (ortho), 1 (backward) or 1/n
    (forward), inverse tables by 1/sqrt(n), 1/n or 1; 'ortho' and
    'backward' as lama_tpu's Pallas kernel builds them
    (ops/pallas/fourier_unit.py:140-146)."""
    from lama_tpu.ops import spectral as jspec
    h, w = 6, 10
    base = tfu.twiddles_np(h, w, pad=False, norm='backward')
    for norm, fwd, inv in (('ortho', lambda n: n ** -0.5, lambda n: n ** 0.5),
                           ('forward', lambda n: 1.0 / n, lambda n: n)):
        # each table over the 'backward' one: forward ones 1 / sqrt(n) or
        # 1 / n, inverse ones sqrt(n) or n over its 1 / n
        t = tfu.twiddles_np(h, w, pad=False, norm=norm)
        for name, factor in (('tw_f', fwd(w)), ('tw_h', fwd(h)),
                             ('tw_ih', inv(h)), ('tw_iw', inv(w))):
            np.testing.assert_allclose(t[name], base[name] * factor,
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    for norm in ('ortho', 'backward'):
        wr, wi = jspec._rdft_mats(w, norm)
        ours = tfu._rdft_mats(w, norm)
        np.testing.assert_allclose(ours[0], wr, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ours[1], wi, rtol=1e-6, atol=1e-7)
        cr, ci = jspec._irdft_mats(w, norm)
        ours = tfu._irdft_mats(w, norm)
        np.testing.assert_allclose(ours[0], cr, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ours[1], ci, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match='fft norm'):
        tfu.check_norm('unitary')


@pytest.mark.parametrize('b,h,w,c,co', [(1, 7, 5, 3, 2), (2, 9, 6, 4, 4),
                                        (1, 5, 11, 8, 8), (1, 6, 95, 4, 4)])
def test_fourier_unit_padded_tables_replay_equal_to_unpadded(b, h, w, c, co):
    """The tables' row pitch padded to 4 floats changes only addresses:
    the replay reads the same values and gives the same bits."""
    padded, _ = _replay_unit(b, h, w, c, co, pad=True)
    plain, _ = _replay_unit(b, h, w, c, co, pad=False)
    assert np.array_equal(padded, plain)
    for name, t in tfu.twiddles_np(h, w).items():
        u = tfu.twiddles_np(h, w, pad=False)[name]
        assert t.shape[1] == tfu.pitch(u.shape[1]) and t.shape[1] % 4 == 0
        assert np.array_equal(t[:, :u.shape[1]], u)
        assert not t[:, u.shape[1]:].any()


@pytest.mark.parametrize('w', [1, 2, 5, 6, 48, 64, 95, 128])
def test_fourier_unit_drops_only_spectrum_rows_that_are_zero(w):
    """In `freq_order` the real W-DFT's rows past the first W are Im at f
    = 0 and, for even W, at f = W / 2: zero (to float64 rounding) for any
    input, as are the inverse's weights on them. The tables keep the first
    W rows (tw_f) and columns (tw_iw) of the reordered DFTs."""
    wf = w // 2 + 1
    order = tfu.freq_order(w)
    assert sorted(order) == list(range(wf))
    assert order[-1] == 0 and (w % 2 or order[-2] == w // 2)
    wr, wi = tfu._rdft_mats(w)
    cr, ci = tfu._irdft_mats(w)
    fwd = np.concatenate([wr.T[order], wi.T[order]])
    inv = np.concatenate([cr.T[:, order], ci.T[:, order]], axis=1)
    assert fwd.shape[0] - w == 2 * wf - w <= tfu.MAX_ZERO_ROWS
    assert np.abs(fwd[w:]).max() < 1e-13 and np.abs(inv[:, w:]).max() < 1e-13
    tables = tfu.twiddles_np(3, w, pad=False)
    np.testing.assert_array_equal(tables['tw_f'], fwd[:w].astype(np.float32))
    np.testing.assert_array_equal(tables['tw_iw'],
                                  inv[:, :w].astype(np.float32))


CHIP_FU_SHAPES = [(16, 192, 64, 64), (1, 192, 128, 128), (1, 192, 125, 95),
                  (1, 192, 63, 48)]


@pytest.mark.parametrize('x_bf16', [False, True])
@pytest.mark.parametrize('b,c,h,w', CHIP_FU_SHAPES)
def test_fourier_unit_plan_at_the_chip_shapes(b, c, h, w, x_bf16):
    """At the served and refine shapes: five launches; every operand takes
    16-byte runs (`vec`), each run of 4 fp32 (8 bf16) elements lying in
    one split segment of consecutive addresses and starting 16-byte
    aligned; the tables' rows at a pitch of whole runs; and each stage's
    whole tiles and chunks do at most 10% more FMAs than its M N K."""
    plan = tfu._stage_plan(b, h, w, c, c, x_bf16)
    tables = tfu.twiddles_np(h, w)
    assert [st['stage'] for st in plan] == list(tfu.STAGE_NAMES)
    for st in plan:
        m, n, k, bm = st['M'], st['N'], st['K'], st['bm']
        for key, (name, row, col, vec), n_rows, n_cols, ev in _operands(
                st, x_bf16):
            assert vec and _runs_ok(row, col, n_rows, n_cols, ev), (
                st['stage'], key)
            if name in tables:
                assert row[2] == tables[name].shape[1]
                assert tables[name].shape[1] % 4 == 0
                assert tables[name].shape[0] >= n_rows
        bn = tfu.tile_cols(bm)
        work = ((-(-m // bm) * bm) * (-(-n // bn) * bn)
                * (-(-k // tfu.BK) * tfu.BK))
        assert work <= 1.1 * m * n * k, (st['stage'], work / (m * n * k))


@pytest.mark.parametrize('b,c,h,w,splits', [
    (16, 192, 64, 64, 1),      # 768-792 tiles: whole rounds
    (4, 192, 64, 64, 2),       # 192-198: a second round mostly idle
    (1, 192, 128, 128, 2),
    (1, 192, 125, 95, 4),      # 141-144: 4 splits, 5 rounds of quarters
    (1, 192, 63, 48, 3)])      # 36-39: under one wave
def test_fourier_unit_split_plan_on_an_h100(b, c, h, w, splits):
    """The K splits at the served and refine shapes on 132 SMs, and the
    rule: at most MAX_SPLITS and one stage a run, none where it does not
    cut the rounds of tiles by SPLIT_GAIN."""
    plan = tfu._stage_plan(b, h, w, c, c, sms=132)
    assert [st['splits'] for st in plan] == [splits] * 5
    for st in plan:
        assert st['splits'] <= min(tfu.MAX_SPLITS, -(-st['K'] // tfu.BK))
    assert tfu.split_count(131, 10, 132) == 1
    assert tfu.split_count(44, 2, 132) == 2      # one stage a run at most
    assert tfu.split_count(44, 10, 132) == 3
    assert tfu.workspace_floats(plan[2]) == (
        0 if splits == 1 else splits * plan[2]['M'] * plan[2]['N'])


def test_fourier_unit_tile_rule():
    """The tile height is the instance of least padded area, ties to the
    larger: M = W = 64, 128, 95, 48 at the chip shapes take BM = 64, 128,
    32, 16; a wide M takes 128."""
    assert tfu.tile_rows(64, 16 * 64 * 192) == 64
    assert tfu.tile_rows(128, 128 * 192) == 128
    assert tfu.tile_rows(95, 125 * 192) == 32
    assert tfu.tile_rows(48, 63 * 192) == 16
    assert tfu.tile_rows(16 * 64 * 33, 384) == 128
    for bm in tfu.TILE_ROWS:
        assert bm * tfu.tile_cols(bm) == tfu.THREADS * tfu.OUTPUTS_PER_THREAD


def test_fourier_unit_source_matches_its_plan():
    """csrc/fourier_unit.cu's constants, instances, structures and launcher
    signature are the wrapper's; every instance's ring of STAGES fits one block in
    both B types; each quarter-warp reads one A row (a broadcast) and 8
    consecutive 16-byte B vectors, and a warp's A rows fall on distinct
    16-byte bank groups (the source's static_assert); the arithmetic is
    fp32 FMA with no TF32 or tensor-core instruction."""
    import ctypes
    import re
    with open(_build.source_path('fourier_unit')) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf'\b{name} = (\d+)', src).group(1))

    for name in ('THREADS', 'BK', 'A_PAD', 'STAGES', 'SMEM_LIMIT',
                 'MAX_ZERO_ROWS', 'MAX_SPLITS'):
        assert const(name) == getattr(tfu, name), name
    # split i of a tile sums the stages [i chunks / s, (i + 1) chunks / s);
    # the reduction adds the partial planes in order, then the epilogue
    assert 'c0 = SPLIT ? sp * chunks / splits : 0;' in src
    assert 'c1 = SPLIT ? (sp + 1) * chunks / splits : chunks;' in src
    body = src[src.index('split_reduce_kernel(int M'):]
    body = body[:body.index('\n}\n')]
    assert body.index('float4 s = *reinterpret_cast<const float4*>(src);') \
        < body.index('for (int k = 1; k < splits; ++k)') \
        < body.index('v[e] += C.bias[n + e]')
    assert 'splits > MAX_SPLITS ||\n      splits > (K + BK - 1) / BK' in src
    assert 'constexpr int NO_SPLIT = 1 << 30;' in src
    assert tfu.NO_SPLIT == 1 << 30
    assert 'BM * BN = 16384' in src and tfu.THREADS * 64 == 16384
    cases = re.findall(r'case (\d+): return launch_bm<(\d+)>', src)
    assert sorted(int(a) for a, b in cases) == sorted(tfu.TILE_ROWS)
    assert all(a == b for a, b in cases)

    def names(struct):
        body = src[src.index(f'struct {struct} {{'):]
        body = re.sub(r'//.*', '', body[:body.index('};')]).split('{', 1)[1]
        out = []
        for decl in body.split(';'):
            if decl.strip():
                out += [re.findall(r'\w+', v)[-1] for v in decl.split(',')]
        return out

    assert names('SplitIdx') == [f for f, _ in tfu._Split._fields_]
    assert names('GemmView') == [f for f, _ in tfu._View._fields_]
    assert names('GemmOut') == [f for f, _ in tfu._Out._fields_]
    sig = src[src.index('extern "C" int lama_fu_gemm('):]
    params = sig[sig.index('(') + 1:sig.index(')')].split(',')
    kinds = [ctypes.c_void_p if '*' in p else ctypes.c_int for p in params]
    assert kinds == tfu.ARGTYPES
    assert [p.split()[-1].lstrip('*') for p in params] == [
        'M', 'N', 'K', 'bm', 'splits', 'A', 'B', 'C', 'ws', 'stream']
    for bm in tfu.TILE_ROWS:
        for elem in (4, 2):
            assert tfu.STAGES * tfu.stage_bytes(bm, elem) <= tfu.SMEM_LIMIT
        a_pitch = tfu.BK + tfu.A_PAD
        assert a_pitch % 4 == 0
        tiles = [tfu.thread_tile(t, bm) for t in range(tfu.THREADS)]
        assert sorted(tiles) == sorted((g, t) for g in range(bm // 8)
                                       for t in range(tfu.THREADS * 8 // bm))
        for warp in range(tfu.THREADS // 32):
            lanes = tiles[32 * warp:32 * warp + 32]
            for q in range(4):
                quarter = lanes[8 * q:8 * q + 8]
                assert len({g for g, _ in quarter}) == 1
                tn = sorted(t for _, t in quarter)
                assert tn == list(range(tn[0], tn[0] + 8))
            rows = {g for g, _ in lanes}
            assert len({(g * a_pitch // 4) % 8 for g in rows}) == len(rows)
    assert 'const int tn = (warp % WARPS_N) * T::WC + lane % T::WC;' in src
    assert 'const int tg = (warp / WARPS_N) * T::WR + lane / T::WC;' in src
    code = re.sub(r'//.*', '', src).lower()
    assert 'acc[j][0] += av * f.b0[q].x' in code
    for gone in ('tf32', 'mma', 'wmma', 'nvcuda', 'cvt.rna', 'atomic'):
        assert gone not in code, gone


@pytest.mark.parametrize('b,c,h,w,co', [(b, c, h, w, c)
                                        for b, c, h, w in CHIP_FU_SHAPES]
                         + [(2, 8, 7, 5, 3)])
def test_chip_smoke_fourier_unit_bound_is_the_pallas_cost_estimate(b, c, h, w,
                                                                    co):
    """chip_smoke.py's FourierUnit FLOP count (its bound) is the formula of
    the TPU kernel's cost estimate, read from its source."""
    import re
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    with open(os.path.join(repo, 'lama_tpu', 'ops', 'pallas',
                           'fourier_unit.py')) as f:
        expr = re.search(r'flops=(.*?),\s*bytes_accessed', f.read(),
                         re.S).group(1)
    want = eval(expr, {'b': b, 'h': h, 'w': w, 'wf': w // 2 + 1, 'c': c,
                       'c_out': co})
    assert chip_smoke.fu_flop(b, c, h, w, co) == want
    args = [torch.empty(b, c, h, w, device='meta'),
            torch.empty(2 * co, 2 * c, 1, 1, device='meta')] + [
        torch.empty(2 * co, device='meta') for _ in range(5)]
    ms, by = chip_smoke.bound('fused_fourier_unit', 'fu', args, 'fp32')
    flop_ms = want / chip_smoke.FP32_FLOPS * 1e3
    assert ms == pytest.approx(max(flop_ms, ms)) and ms >= flop_ms
    if (b, c, h, w) == (16, 192, 64, 64):
        assert want == pytest.approx(19.93e9, rel=1e-3)
        assert by == 'operations' and ms == pytest.approx(0.2975, rel=1e-3)


def _replay_conv3x3_wgmma(x, weight, stride=1):
    """numpy model of csrc/conv3x3_wgmma.cu at one shape and stride: per
    tile and input-channel chunk, the reflect-mapped halo in the kernel's
    shared-memory image ([slot * groups + 8-channel group][halo pixel][8];
    at stride 2 the halo pixels are width pairs, slot 0 the even input
    column, slot 1 the odd), the packed weights of each output-channel tile
    as the kernel's copies take them into a stage, and per m64 sub-tile,
    tap and 16-channel step the A and B operands read through their (start,
    LBO, SBO) descriptors as wgmma reads K-major core matrices; the tap
    GEMMs summed in float64."""
    from lama_tpu_torch.ops.kernels import conv3x3_wgmma as wg
    b, h, w, c = x.shape
    co = weight.shape[0]
    ho, wo = h // stride, w // stride
    cc = wg.chunk_c(stride)
    chunks, nt = -(-c // cc), -(-co // wg.BLOCK_N)
    groups = cc // wg.GROUP_C
    hh, hw = wg.halo_shape(stride)
    xp = np.zeros((b, h, w, chunks * cc))
    xp[..., :c] = x
    origins = wg.tile_origins(h, w, stride)
    src = [wg.halo_source(r0, c0, h, w, stride) for r0, c0 in origins]
    rows = np.array([r for r, _ in src])             # (T, hh)
    cols = np.array([cs for _, cs in src])           # (T, slots, hw)
    halo = xp[:, rows[:, None, :, None], cols[:, :, None, :], :]
    halo = halo.reshape(b, len(origins), stride, hh, hw, chunks, groups,
                        wg.GROUP_C).transpose(0, 1, 5, 2, 6, 3, 4, 7)
    halo = torch.from_numpy(halo.reshape(b, len(origins), chunks, -1))
    # the stage's weights: stage chunk k is part k % split of packed chunk
    # k // split, `groups` of the packed chunk's groups of each tap
    pack_groups, split = wg.CHUNK_C // wg.GROUP_C, wg.CHUNK_C // cc
    packed = wg.pack_conv3x3_weight(torch.from_numpy(weight), torch.float64)
    packed = packed.reshape(nt, -1, wg.GROUP_C)       # 16-byte items
    tap, r = np.divmod(np.arange(9 * groups * wg.BLOCK_N), groups * wg.BLOCK_N)
    items = np.stack([((k // split) * 9 * pack_groups + (k % split) * groups)
                      * wg.BLOCK_N + tap * pack_groups * wg.BLOCK_N + r
                      for k in range(chunks)])
    wbuf = packed[:, torch.from_numpy(items)].reshape(nt, chunks, -1)
    assert wbuf.shape[-1] * wg.BYTES == 9 * cc * wg.BLOCK_N * 2

    def operand(desc, rows_):
        # element (row, k) of a K-major no-swizzle operand, in bf16 units
        start, lbo, sbo = desc
        assert start % 16 == 0 and lbo % 16 == 0 and sbo % 16 == 0
        assert max(start, lbo, sbo) >> 4 < 1 << 14   # 14-bit fields
        r, k = np.arange(rows_)[:, None], np.arange(16)[None, :]
        byte = start + (r // 8) * sbo + (r % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
        return torch.from_numpy(byte // wg.BYTES)

    acc = torch.zeros(b, len(origins), nt, wg.TILE_H * wg.TILE_W, wg.BLOCK_N,
                      dtype=torch.float64)
    m = np.arange(64)
    for sr in range(wg.TILE_H // wg.SUB):
        for sc in range(wg.TILE_W // wg.SUB):
            pix = (wg.SUB * sr + m // 8) * wg.TILE_W + wg.SUB * sc + m % 8
            for tap in range(9):
                for j in range(cc // 16):
                    a = halo[..., operand(
                        wg.a_descriptor(sr, sc, tap, j, stride), 64)]
                    bm = wbuf[..., operand(wg.b_descriptor(tap, j, stride),
                                           wg.BLOCK_N)]
                    acc[:, :, :, pix] += torch.einsum('btcmk,ucnk->btumn', a, bm)
    out = np.zeros((b, ho, wo, nt * wg.BLOCK_N))
    acc = acc.numpy()
    for t, (r0, c0) in enumerate(origins):
        tile = acc[:, t].transpose(0, 2, 1, 3).reshape(
            b, wg.TILE_H, wg.TILE_W, nt * wg.BLOCK_N)
        rr, cc_ = min(wg.TILE_H, ho - r0), min(wg.TILE_W, wo - c0)
        out[:, r0:r0 + rr, c0:c0 + cc_] = tile[:, :rr, :cc_]
    return out[..., :co]


@pytest.mark.parametrize('b,c,co,h,w', [(2, 24, 40, 37, 29),
                                        (1, 128, 384, 125, 95),
                                        (1, 384, 128, 9, 8),
                                        (2, 512, 512, 16, 16),
                                        (2, 128, 128, 16, 16),
                                        (1, 128, 128, 125, 95)])
def test_conv3x3_wgmma_plan_matches_plain(b, c, co, h, w):
    """The bf16 wgmma kernel's stride-1 plan (kernels 2, 3 and 6), replayed
    on the CPU from the wrapper's constants and weight packing, equals the
    plain reflect conv: the refiner's odd 125x95 bottleneck (taps and cols),
    kernel 3's g2l at 9x8, a 512-channel block, kernel 2's 128 -> 128 and
    channel tails (C % 32, C_out % 128)."""
    rng = np.random.RandomState(c + co)
    x = rng.rand(b, h, w, c).astype(np.float32)
    weight = (rng.randn(co, c, 3, 3) * (9 * c) ** -0.5).astype(np.float32)
    ref = trc.reflect_conv_plain(_nchw(x), torch.from_numpy(weight))
    np.testing.assert_allclose(_replay_conv3x3_wgmma(x, weight), _nhwc(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('b,c,co,h,w', [(2, 64, 128, 16, 24),
                                        (1, 128, 256, 26, 10),
                                        (1, 256, 384, 8, 8),
                                        (1, 64, 128, 50, 38)])
def test_conv3x3_wgmma_s2_plan_matches_plain(b, c, co, h, w):
    """The stride-2 plan (kernel 4's bf16 path: the width-pair halo, its
    descriptors and the half-chunk weight stages), replayed on the CPU,
    equals the plain stride-2 reflect conv: down1-like 64 -> 128, partial
    tiles (13x5 outputs) over two N tiles, down3's l2g over three, and the
    refiner's halved odd sides (50x38 -> 25x19)."""
    rng = np.random.RandomState(c + co + h)
    x = rng.rand(b, h, w, c).astype(np.float32)
    weight = (rng.randn(co, c, 3, 3) * (9 * c) ** -0.5).astype(np.float32)
    ref = trc.reflect_conv_plain(_nchw(x), torch.from_numpy(weight), stride=2)
    np.testing.assert_allclose(_replay_conv3x3_wgmma(x, weight, stride=2),
                               _nhwc(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('c,co', [(24, 40), (512, 512), (1, 130)])
def test_pack_conv3x3_weight_round_trips(c, co):
    """pack_conv3x3_weight is a zero-filled relayout of the OIHW weight."""
    from lama_tpu_torch.ops.kernels import conv3x3_wgmma as wg
    weight = torch.randn(co, c, 3, 3, generator=torch.Generator().manual_seed(c))
    chunks, nt = -(-c // wg.CHUNK_C), -(-co // wg.BLOCK_N)
    for dtype in (torch.float32, torch.bfloat16):
        packed = wg.pack_conv3x3_weight(weight, dtype)
        assert packed.dtype == dtype and packed.is_contiguous()
        back = packed.reshape(nt, chunks, 3, 3, wg.CHUNK_C // wg.GROUP_C,
                              wg.BLOCK_N, wg.GROUP_C).permute(0, 5, 1, 4, 6, 2, 3)
        back = back.reshape(nt * wg.BLOCK_N, chunks * wg.CHUNK_C, 3, 3)
        assert torch.equal(back[:co, :c], weight.to(dtype))
        assert not back[co:].any() and not back[:, c:].any()


def test_conv3x3_wgmma_source_matches_its_plan():
    """The CUDA source's tile, chunk and stage constants are the Python
    plan's, its shared memory fits one block, and it is built."""
    import re

    from lama_tpu_torch.ops.kernels import conv3x3_wgmma as wg
    with open(_build.source_path('conv3x3_wgmma')) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf'\b{name} = (\d+)', src).group(1))

    for name in ('TILE_H', 'TILE_W', 'SUB', 'BLOCK_N', 'CHUNK_C', 'GROUP_C',
                 'STAGES'):
        assert const(name) == getattr(wg, name), name
    assert 'conv3x3_wgmma' in _build.SOURCES
    halo = (wg.CHUNK_C // wg.GROUP_C) * wg.HALO_H * wg.HALO_W * 16
    weights = 9 * wg.CHUNK_C * wg.BLOCK_N * wg.BYTES
    assert wg.STAGES >= 2 and wg.STAGES * (halo + weights) <= 232448
    assert wg.TILE_H * wg.TILE_W >= 128 and wg.BLOCK_N >= 128
    # stride 2: its constants, both launchers, and the ring's fit
    for name in ('S2_CHUNK_C', 'S2_STAGES', 'SMEM_LIMIT'):
        assert const(name) == getattr(wg, name), name
    for symbol in wg.LAUNCHERS.values():
        assert f'extern "C" int {symbol}(' in src, symbol
    assert (wg.S2_HALO_H, wg.S2_HALO_W) == (2 * wg.TILE_H + 1, wg.TILE_W + 1)
    assert wg.CHUNK_C % wg.S2_CHUNK_C == 0 and wg.S2_CHUNK_C % 16 == 0
    out_stage = wg.TILE_H * wg.TILE_W * (wg.BLOCK_N + 8) * wg.BYTES
    for stride, stages in ((1, wg.STAGES), (2, wg.S2_STAGES)):
        assert stages >= 2 and stages * wg.stage_bytes(stride) <= wg.SMEM_LIMIT
        assert out_stage <= stages * wg.stage_bytes(stride)
    assert wg.stage_bytes(1) == halo + weights
    # why 16 channels at stride 2: two 32-channel pair-halo stages overflow
    s2_halo32 = 2 * (wg.CHUNK_C // wg.GROUP_C) * wg.S2_HALO_H * wg.S2_HALO_W * 16
    assert 2 * (s2_halo32 + weights) > wg.SMEM_LIMIT


def test_reflect_conv_source_keeps_no_bf16_3x3_path():
    """reflect_conv.cu holds no 3x3 kernel (its bf16 launches are
    conv3x3_wgmma.cu's); the 7x7 head keeps its bf16 instance."""
    with open(_build.source_path('reflect_conv')) as f:
        src = f.read()
    for gone in ('mma.h', 'nvcuda', 'wmma', 'Conv3Cfg<bf16>',
                 'launch_conv3<bf16'):
        assert gone not in src, gone
    assert 'launch_co<bf16>' in src


def test_cuda_sources_and_build_flags():
    for name in _build.SOURCES:
        assert os.path.isfile(_build.source_path(name)), name
    assert 'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.endswith(os.path.join('lama_tpu_torch', '_build'))
    # importing the wrappers builds and loads nothing
    assert not _build._loaded


def test_kernels_refuse_to_drop_gradients():
    """The kernels' autograd wrapper gives first-order gradients (the plain
    version's VJP) and, under create_graph, the second order too (the R1
    penalty of a discriminator whose convs are kernels), equal to plain
    autograd's, rather than dropping it (tests/test_torch_autograd.py
    holds it by gradgradcheck)."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1, 4, 8, 8, generator=g, requires_grad=True)
    w = torch.rand(4, 4, 3, 3, generator=g, requires_grad=True)

    def second_order(conv):
        out = conv(trc.reflect_conv_plain, trc.reflect_conv_plain, x, w, None)
        gx, = torch.autograd.grad(out.square().sum(), x, create_graph=True)
        return torch.autograd.grad(gx.square().sum(), w)[0]

    ours = second_order(_autograd.differentiable)
    ref = second_order(lambda kernel, plain, *args: plain(*args))
    assert bool(ours.abs().max() > 0)
    torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-6)
    with torch.no_grad():   # no gradient needed: the kernel's output as is
        assert not _autograd.differentiable(trc.reflect_conv_plain,
                                            trc.reflect_conv_plain,
                                            x, w, None).requires_grad


def _replay_conv3x3_simt(x, weight, stride=1, splits=1, bias=None):
    """numpy model of csrc/conv3x3_simt.cu at one shape and stride: per
    tile, output-channel tile, split and input-channel chunk of that
    split's run, the stage's shared-memory image as the kernel's copies
    fill it (halo item i is 16-byte vector i % VPP of halo pixel i // VPP,
    at that pixel's pitch, from the reflect-mapped source pixel, zero past
    C; then the stage's run of packed weights), and per thread its 8
    pixels x 8 channels read off that image at the kernel's A and B offsets
    for each tap and channel; the products summed in float64, scattered to
    the thread's outputs and masked at the edges: to the output (splits =
    1) or to the split's plane of the workspace (splits > 1), whose planes
    split_reduce_kernel's model then sums in order 0 .. splits - 1 before
    the bias."""
    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    b, h, w, c = x.shape
    co = weight.shape[0]
    ho, wo = sm.out_size(h, stride), sm.out_size(w, stride)
    ck = sm.chunk_c(stride)
    chunks, n_tiles = -(-c // ck), -(-co // sm.BLOCK_N)
    hh, hw = sm.halo_shape(stride)
    pitch, hf = sm.pitch(stride), sm.halo_floats(stride)
    nf = hf + sm.weight_floats(stride)
    assert sm.stage_bytes(stride) == nf * sm.BYTES
    packed = sm.pack_conv3x3_weight(torch.from_numpy(weight),
                                    stride).double().numpy()
    assert packed.size == n_tiles * chunks * sm.weight_floats(stride)
    xp = np.zeros((b, h, w, chunks * ck))
    xp[..., :c] = x
    # the kernel's halo copies of one stage
    vpp = ck // 4
    item = np.arange(hh * hw * vpp)
    pix, vec = item // vpp, item % vpp
    dst = (pix * pitch + 4 * vec)[:, None] + np.arange(4)
    src_c = (4 * vec)[:, None] + np.arange(4)
    # each thread's operand offsets: A (thread, pixel, tap, channel) and
    # B (thread, tap, channel, output channel), and its outputs
    tiles = [sm.thread_tile(t) for t in range(sm.THREADS)]
    taps, cs = range(9), range(ck)
    a_idx = np.array([[[[sm.a_offset(r, c0 + j, t, k, stride) for k in cs]
                        for t in taps] for j in range(8)]
                      for r, c0, _ in tiles])
    b_idx = np.array([[[[sm.b_offset(t, k, n, stride)
                         for n in sm.thread_channels(tn)] for k in cs]
                       for t in taps] for _, _, tn in tiles])
    out_r = np.array([[r] * 8 for r, _, _ in tiles])
    out_c = np.array([[c0 + j for j in range(8)] for _, c0, _ in tiles])
    out_n = np.array([sm.thread_channels(tn) for _, _, tn in tiles])
    # every (pixel, channel) of the block's tile is one thread's, once
    owned = {(r, cc, n) for t in range(sm.THREADS) for r, cc in
             zip(out_r[t], out_c[t]) for n in out_n[t]}
    assert len(owned) == sm.TILE_H * sm.TILE_W * sm.BLOCK_N == sm.THREADS * 64
    # the workspace (splits, B, Ho, Wo, C_out padded to BLOCK_N); its one
    # plane is the output itself when unsplit
    ws = np.full((splits, b, ho, wo, n_tiles * sm.BLOCK_N), np.nan)
    runs = [sm.split_chunks(i, splits, chunks) for i in range(splits)]
    assert [k0 for k0, _ in runs[1:]] == [k1 for _, k1 in runs[:-1]]
    assert runs[0][0] == 0 and runs[-1][1] == chunks
    for r0, c0 in sm.tile_origins(h, w, stride):
        rows, cols = sm.halo_source(r0, c0, h, w, stride)
        halo = xp[:, rows][:, :, cols].reshape(b, hh * hw, -1)
        for nt in range(n_tiles):
            for i, (k0, k1) in enumerate(runs):
                acc = np.zeros((b, sm.THREADS, 8, 8))
                for k in range(k0, k1):
                    stage = np.zeros((b, nf))
                    stage[:, dst] = halo[:, pix[:, None], k * ck + src_c]
                    off = sm.weight_offset(nt, k, chunks, stride)
                    stage[:, hf:] = packed[off:off + nf - hf]
                    acc += np.einsum('bsjtc,stcn->bsjn', stage[:, a_idx],
                                     stage[0][b_idx])
                for t in range(sm.THREADS):
                    for j in range(8):
                        r, cc = r0 + out_r[t, j], c0 + out_c[t, j]
                        if r < ho and cc < wo:
                            plane = ws[i]
                            plane[:, r, cc, nt * sm.BLOCK_N + out_n[t]] = \
                                acc[:, t, j]
    out = ws[0]
    for i in range(1, splits):   # split_reduce_kernel's order
        out = out + ws[i]
    out = out[..., :co]
    return out if bias is None else out + bias


def _simt_case(stride, b, c, co, h, w, sms=None, splits=1):
    """A case of the test below; the unsplit ones keep their ids."""
    ident = '-'.join(map(str, (stride, b, c, co, h, w)))
    if sms is not None:
        ident += f'-sms{sms}-s{splits}'
    return pytest.param(stride, b, c, co, h, w, sms, splits, id=ident)


@pytest.mark.parametrize('stride,b,c,co,h,w,sms,splits', [
    _simt_case(1, 2, 24, 40, 37, 29),   # kernel 6's tiny_odd: C % 16, C_out % 128
    _simt_case(1, 1, 3, 5, 9, 13),      # C % 4: element copies, partial tiles
    _simt_case(1, 1, 64, 136, 16, 16),  # four chunks, two N tiles
    _simt_case(1, 1, 1, 1, 2, 2),       # the smallest input a pad of 1 takes
    _simt_case(2, 1, 64, 128, 16, 34),  # down1-like: eight chunks, 8 x 17 outputs
    _simt_case(2, 1, 20, 130, 18, 10),  # C % 8, C_out % 128, partial tiles
    _simt_case(2, 2, 8, 24, 26, 12),
    # K split over 2-4 blocks at a small SM count, odd 13 x 11 bottlenecks
    # (two tiles): l2l-like 16 chunks in runs of 8 and of 5, 5, 6; l2g-like
    # three N tiles in runs of 5, 5, 6; g2l-like 48 chunks in 4 runs; 25
    # chunks in 6, 6, 6, 7 with two images, C_out % 4 and a bias
    _simt_case(1, 1, 128, 128, 13, 11, sms=4, splits=2),
    _simt_case(1, 1, 128, 128, 13, 11, sms=6, splits=3),
    _simt_case(1, 1, 128, 384, 13, 11, sms=18, splits=3),
    _simt_case(1, 1, 384, 128, 13, 11, sms=8, splits=4),
    _simt_case(1, 2, 200, 130, 13, 11, sms=32, splits=4),
])
def test_conv3x3_simt_plan_matches_plain(stride, b, c, co, h, w, sms, splits):
    """The fp32 SIMT kernel's plan (kernels 2, 3, 4 and 6 in fp32), replayed
    on the CPU from the wrapper's constants, plan and weight packing,
    equals the plain reflect conv at both strides: channel tails, partial
    edge tiles, several chunks and N tiles, kernel 6's odd tiny shape, and
    the split over K that the plan chooses on a card of `sms` SMs (its
    chunk runs, the workspace and the reduction in order, the bias after
    it)."""
    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    rng = np.random.RandomState(c + co + h)
    x = rng.rand(b, h, w, c).astype(np.float32)
    weight = (rng.randn(co, c, 3, 3) * (9 * c) ** -0.5).astype(np.float32)
    # a bias where C_out % 4 != 0 (the element stores)
    bias = rng.randn(co).astype(np.float32) if co == 130 else None
    if sms is not None:
        assert sm.plan_splits(b, h, w, c, co, sms) == splits
    ref = trc.reflect_conv_plain(_nchw(x), torch.from_numpy(weight),
                                 None if bias is None else torch.from_numpy(bias),
                                 stride=stride)
    np.testing.assert_allclose(
        _replay_conv3x3_simt(x, weight, stride, splits, bias), _nhwc(ref),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('b,h,w,c,co,blocks,splits', [
    (10, 32, 32, 128, 128, 80, 3),     # train l2l
    (10, 32, 32, 384, 128, 80, 3),     # train g2l
    (10, 32, 32, 128, 384, 240, 1),    # train l2g: 1.8 waves
    (1, 125, 95, 128, 128, 96, 4),     # refine 125x95 l2l
    (1, 125, 95, 384, 128, 96, 4),     # refine 125x95 g2l
    (1, 125, 95, 128, 384, 288, 1),    # refine 125x95 l2g: 2.2 waves
    (1, 63, 48, 128, 128, 24, 4),      # refine 63x48 l2l: the cap
    (1, 63, 48, 384, 128, 24, 4),      # refine 63x48 g2l: the cap
    (1, 63, 48, 128, 384, 72, 3),      # refine 63x48 l2g
    (1, 128, 128, 128, 128, 128, 1),   # refine 1024^2 l2l: 97% of a wave
    (4, 64, 64, 128, 128, 128, 1),     # b4 l2l
    (4, 64, 64, 384, 128, 128, 1),     # b4 g2l
    (4, 64, 64, 128, 384, 384, 1),     # b4 l2g
    (16, 64, 64, 128, 128, 512, 1),    # b16 l2l
    (16, 64, 64, 384, 128, 512, 1),    # b16 g2l
    (4, 64, 64, 512, 512, 512, 1),     # kernel 6 block b4
    (10, 32, 32, 512, 512, 320, 1),    # kernel 6 train block
    (2, 37, 29, 24, 40, 20, 1),        # kernel 6 tiny_odd: 3 chunks
])
def test_conv3x3_simt_split_plan_on_an_h100(b, h, w, c, co, blocks, splits):
    """The split over K at the port's stride-1 shapes on an H100 (132 SMs):
    only grids under one wave split, into at most MAX_SPLITS runs of at
    least STAGES chunks, the fewest within 5% of the least time in waves."""
    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    assert sm.grid_blocks(b, h, w, co) == blocks
    assert sm.plan_splits(b, h, w, c, co, 132) == splits
    chunks = -(-c // sm.CHUNK_C)
    assert splits == 1 or (blocks < 132 and chunks >= sm.STAGES * splits)


@pytest.mark.parametrize('stride,c,co', [(1, 24, 40), (1, 512, 512),
                                         (2, 64, 128), (2, 3, 130)])
def test_pack_conv3x3_simt_weight_round_trips(stride, c, co):
    """conv3x3_simt.pack_conv3x3_weight is a zero-filled relayout of the
    OIHW weight: [n tile][chunk][tap][channel][128]."""
    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    weight = torch.randn(co, c, 3, 3, generator=torch.Generator().manual_seed(c))
    ck = sm.chunk_c(stride)
    chunks, nt = -(-c // ck), -(-co // sm.BLOCK_N)
    packed = sm.pack_conv3x3_weight(weight, stride)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    back = packed.reshape(nt, chunks, 3, 3, ck, sm.BLOCK_N).permute(
        0, 5, 1, 4, 2, 3).reshape(nt * sm.BLOCK_N, chunks * ck, 3, 3)
    assert torch.equal(back[:co, :c], weight)
    assert not back[co:].any() and not back[:, c:].any()


def test_conv3x3_simt_source_matches_its_plan():
    """The CUDA source's tile, chunk, stage and pitch constants are the
    Python plan's, both launchers are there, every stage ring fits one
    block, and the plan's shared-memory reads are conflict-free: per
    LDS.128 a quarter-warp reads one A vector and 8 consecutive B vectors,
    and a warp's distinct A vectors lie on distinct 16-byte bank groups."""
    import re

    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    with open(_build.source_path('conv3x3_simt')) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf'\b{name} = (\d+)', src).group(1))

    for name in ('TILE_H', 'TILE_W', 'BLOCK_N', 'THREADS', 'CHUNK_C',
                 'STAGES', 'S2_CHUNK_C', 'S2_STAGES', 'PITCH_PAD',
                 'SMEM_LIMIT'):
        assert const(name) == getattr(sm, name), name
    assert 'conv3x3_simt' in _build.SOURCES
    for symbol in sm.LAUNCHERS.values():
        assert f'extern "C" int {symbol}(' in src, symbol
    assert sm.TILE_H * sm.TILE_W >= 128 and sm.BLOCK_N >= 128
    for stride in (1, 2):
        assert sm.stages(stride) >= 2
        assert sm.stages(stride) * sm.stage_bytes(stride) <= sm.SMEM_LIMIT
        assert sm.pitch(stride) % 4 == 0 and sm.chunk_c(stride) % 4 == 0
        for warp in range(sm.THREADS // 32):
            tiles = [sm.thread_tile(32 * warp + lane) for lane in range(32)]
            for tap in range(9):
                for c in range(0, sm.chunk_c(stride), 4):
                    a = [sm.a_offset(r, c0, tap, c, stride) for r, c0, _ in tiles]
                    bv = [sm.b_offset(tap, c, 4 * tn, stride) for _, _, tn in tiles]
                    for q in range(4):
                        quarter = slice(8 * q, 8 * q + 8)
                        assert len(set(a[quarter])) == 1
                        assert sorted(bv[quarter]) == list(range(
                            min(bv[quarter]), min(bv[quarter]) + 32, 4))
                    assert bv[:8] * 4 == bv
                    groups = {(off // 4) % 8 for off in set(a)}
                    assert len(groups) == len(set(a)) == 4


def test_conv3x3_simt_split_source_matches_its_plan():
    """The stride-1 launcher and split_reduce_kernel agree with the Python
    plan: the split cap, each split's run of chunks, the workspace's
    padded channel pitch and split-major layout, the launchers' ctypes
    signature (both take splits and the workspace), and the reduction's
    order (split 0 first, the bias after the sum)."""
    import ctypes
    import re

    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    with open(_build.source_path('conv3x3_simt')) as f:
        src = f.read()
    assert int(re.search(r'\bMAX_SPLITS = (\d+)', src).group(1)) == sm.MAX_SPLITS
    # split i's chunks are [i * chunks / s, (i + 1) * chunks / s)
    assert 'k0 = SPLIT ? split * chunks / splits : 0' in src
    assert 'nk = SPLIT ? (split + 1) * chunks / splits - k0 : chunks' in src
    for i, s in [(0, 1), (0, 3), (2, 3), (3, 4)]:
        assert sm.split_chunks(i, s, 16) == (i * 16 // s, (i + 1) * 16 // s)
    # the workspace: (splits, B, Ho, Wo, n_tiles * BLOCK_N)
    assert 'const int cop = gridDim.y * BLOCK_N;' in src
    assert 'split * plane + (size_t(b) * Ho + r) * Wo + c) * cop' in src
    assert 'n_tiles * BLOCK_N, splits, vec_out' in src
    # the reduction: split 0, then 1 .. splits - 1 in order, then the bias
    body = src[src.index('split_reduce_kernel('):]
    body = body[:body.index('\n}\n')]
    assert body.index('float4 s = *reinterpret_cast<const float4*>(src);') \
        < body.index('for (int k = 1; k < splits; ++k)') \
        < body.index('v[e] += bias[n + e]')
    assert 'atomic' not in re.sub(r'//.*', '', src)   # code, not comments
    # both launchers' parameters, in the wrapper's ctypes order
    for symbol in sm.LAUNCHERS.values():
        sig = src[src.index(f'extern "C" int {symbol}('):]
        params = sig[sig.index('(') + 1:sig.index(')')].split(',')
        kinds = [ctypes.c_void_p if '*' in p else ctypes.c_int for p in params]
        assert kinds == sm.ARGTYPES, symbol
        assert [p.split()[-1].lstrip('*') for p in params][4:11] == [
            'ws', 'B', 'H', 'W', 'C', 'Co', 'splits'], symbol
    assert 'splits > MAX_SPLITS || splits > chunks' in src
    assert '(splits > 1 && (S != 1 ||' in src


def test_conv3x3_simt_source_is_full_fp32():
    """The fp32 kernel does its arithmetic in fp32 FMA: its code (the
    comments aside) holds no TF32 conversion and no tensor-core
    instruction."""
    import re
    with open(_build.source_path('conv3x3_simt')) as f:
        src = re.sub(r'//.*', '', f.read()).lower()
    assert 'acc[j][0] += av * f.b0[q].x' in src
    for gone in ('tf32', 'mma', 'wmma', 'nvcuda', 'cvt.rna', 'bf16', 'half'):
        assert gone not in src, gone


def test_fp32_kernels_4_and_6_left_the_old_sources():
    """The fp32 3x3 kernels (kernels 2, 3 and 4 of reflect_conv.cu, kernel
    6 of halo_conv.cu) are gone from the old sources (conv3x3_simt.cu has
    them): reflect_conv.cu holds the 7x7 head only (since its redesign,
    head_conv_kernel; the old thin kernel is gone), halo_conv.cu kernel 7's
    two kernels."""
    with open(_build.source_path('reflect_conv')) as f:
        rc_src = f.read()
    with open(_build.source_path('halo_conv')) as f:
        hc_src = f.read()
    for gone in ('lama_reflect_down_conv3x3', 'Halo3<S>', 'int S',
                 'lama_reflect_conv3x3_cols', 'lama_reflect_conv3x3_taps',
                 'conv3x3_kernel', 'launch_conv3', 'Conv3Cfg',
                 'conv3_smem_bytes', 'C3_'):
        assert gone not in rc_src, gone
    assert rc_src.count('extern "C"') == 1
    for kept in ('lama_reflect_out_conv7x7', 'head_conv_kernel'):
        assert kept in rc_src, kept
    for gone in ('conv7_thin_kernel', 'launch_conv7', 'C7_'):
        assert gone not in rc_src, gone
    for gone in ('halo_conv3x3_kernel', 'launch_k6', 'K6_',
                 'lama_halo_conv3x3_reflect'):
        assert gone not in hc_src, gone
    for kept in ('halo_conv_kernel', 'halo_conv_tc_kernel',
                 'lama_halo_conv_reflect_tiled'):
        assert kept in hc_src, kept


def test_conv3x3_variants_apply_and_fit():
    """Every variant of the variants tool edits its source where it means
    to, and each fp32 SIMT variant's plan fits one block's shared memory
    and keeps the bank rule the source's static_asserts demand (so a
    variant fails here, not in nvcc on the card)."""
    import re

    from lama_tpu_torch.tools import conv3x3_variants as cv
    for source, variants in cv.VARIANTS.items():
        with open(_build.source_path('conv3x3_' + source)) as f:
            src = f.read()
        for name, subs in variants.items():
            text = src
            for old, new in subs:
                assert text.count(old) == 1, (source, name, old)
                text = text.replace(old, new)
            if source != 'simt':
                continue

            def const(n):
                return int(re.search(rf'\b{n} = (\d+)', text).group(1))

            th, tw = const('TILE_H'), const('TILE_W')
            assert tw % 8 == 0 and th * tw == 128, name
            for stride, ck, ring in ((1, const('CHUNK_C'), const('STAGES')),
                                     (2, const('S2_CHUNK_C'),
                                      const('S2_STAGES'))):
                ckp = ck + const('PITCH_PAD')
                hh, hw = stride * (th - 1) + 3, stride * (tw - 1) + 3
                stage = (hh * hw * ckp + 9 * ck * 128) * 4
                assert ring >= 2 and ring * stage <= const('SMEM_LIMIT'), name
                units = stride * hw * ckp // 4
                assert len({(k * units) % 8 for k in range(4)}) == 4, name


# ------------------------------------------------- kernel 5: the 7x7 head
def _head_source():
    with open(_build.source_path('reflect_conv')) as f:
        return f.read()


def test_head_source_matches_its_plan():
    """head_conv.py's constants are reflect_conv.cu's; the bf16 instance
    runs mma.sync m16n8k16 fed by ldmatrix, the fp32 one plain FFMA (its
    loop holds no TF32 and no tensor-core instruction)."""
    import re

    from lama_tpu_torch.ops.kernels import head_conv as hc
    src = _head_source()

    def const(name):
        m = re.search(rf'constexpr int [^;]*\b{name} = (\d+)', src)
        assert m, name
        return int(m.group(1))

    for name in ('KS', 'PAD', 'THREADS', 'MAX_CO', 'MAX_C', 'MIN_SIDE',
                 'BLOCK_SMEM', 'F_RH', 'F_RW', 'F_TX', 'F_TY', 'F_CK',
                 'F_RING', 'B_MT', 'B_CK', 'B_RING', 'D_ROWS'):
        assert const(name) == getattr(hc, name), name
    assert 'B_TILE_W = B_HALO_W - KS + 1' in src and hc.B_TILE_W == 58
    assert 'B_FRAG_BYTES = 32 * 8' in src
    assert 'return 2 * px + (half ^ ((px >> 2) & 1));' in src
    assert '{ return px ^ ((px >> 3) & 3); }' in src
    assert 'NT = (KS * CO + 7) / 8' in src and 'R = NT <= 3 ? 2 : 1' in src
    assert 'KXP = (KS * CO + 3) / 4 * 4' in src
    assert 'DP = NT * 8 + 1' in src
    # the lines the replay below mirrors: the ldmatrix row a lane
    # addresses, the B fragment a lane loads, where an accumulator lands in
    # the D buffer, the lane's (x, co) pairs
    for line in ('const uint32_t off = 16 * b_unit(rr + 8 * (q & 1), q >> 1);',
                 'wk + (ky * PL::NT + nt) * B_FRAG_BYTES)[lane];',
                 'float* d = dsm + ((16 * mt + g + 8 * hh) % D_ROWS) * PL::DP',
                 'const int x0 = mt == 0 ? 0 : 16 * mt - KS + 1;',
                 'const int x1 = mt == B_MT - 1 ? B_TILE_W : 16 * mt + 16 - KS + 1;',
                 'sum += dsm[((x + kx) % D_ROWS) * PL::DP + kx * CO + co];',
                 'const int lo = (ph + 7) & ~7, hi = (ph + valid) & ~7;'):
        assert line in src, line
    assert 'mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32' in src
    assert 'ldmatrix.sync.aligned.m8n8.x4.shared.b16' in src
    fma = src[src.index('// fp32: one output row'):
              src.index('// bf16: acc[r][mt][nt]')]
    fma = re.sub(r'//.*', '', fma).lower()
    assert 'acc[p][co] += av * w[kx * co + co]' in fma
    for gone in ('tf32', 'mma', 'bf16', 'half'):
        assert gone not in fma, gone
    assert 'reflect_conv' in _build.SOURCES


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_head_layout_fits_and_stages_the_main_weights_once(dtype):
    """Every (C, C_out) of the envelope fits one block's shared memory;
    the served, refine and train head (64 -> 3) stages its weights once a
    block; the bf16 swizzle keeps an ldmatrix phase on 8 bank groups, the
    fp32 one a quarter warp's LDS.128 (column groups 4 tx + j) inside its
    row; the bf16 epilogue sums each output once."""
    from lama_tpu_torch.ops.kernels import head_conv as hc
    for c in range(8, hc.MAX_C + 1, 8):
        for co in range(1, hc.MAX_CO + 1):
            assert hc.layout(dtype, c, co)['total'] <= hc.BLOCK_SMEM, (c, co)
    assert hc.layout(dtype, 64, 3)['once']
    for half in (0, 1):
        assert {hc.b_unit(p, half) % 8 for p in range(8)} == set(range(8))
    for base in (0, 8):
        for j in range(hc.F_RW + hc.KS - 1):
            assert {hc.f_unit(4 * tx + j) % 8
                    for tx in range(base, base + 8)} == set(range(8))
    assert sorted(hc.f_unit(p) for p in range(hc.F_HALO_W)) == list(
        range(hc.F_HALO_W))
    xs = [x for x0, x1 in hc.epilogue_ranges() for x in range(x0, x1)]
    assert xs == list(range(hc.B_TILE_W))
    for mt, (x0, x1) in enumerate(hc.epilogue_ranges()):
        # rows x .. x + 6 staged by now and not yet overwritten in the ring
        assert x1 + hc.KS - 1 <= 16 * mt + 16
        assert x0 >= 16 * mt + 16 - hc.D_ROWS


@pytest.mark.parametrize('c,co', [(64, 3), (24, 8), (8, 1), (136, 5)])
def test_head_pack_weight_layouts(c, co):
    """fp32 [c][ky][kxp], element kx * C_out + co; bf16 B fragments
    [chunk][ky][n-tile][lane][4] at `b_fragment`'s (k, n); zero past C and
    7 C_out."""
    from lama_tpu_torch.ops.kernels import head_conv as hc
    g = torch.Generator().manual_seed(c + co)
    wt = torch.rand(co, c, 7, 7, generator=g) + 0.5
    f32 = hc.pack_weight(wt, torch.float32).view(c, 7, hc.kxp(co))
    torch.testing.assert_close(
        f32[:, :, :7 * co].view(c, 7, 7, co), wt.permute(1, 2, 3, 0))
    assert f32[:, :, 7 * co:].abs().sum() == 0
    nt, chunks = hc.n_tiles(co), -(-c // hc.B_CK)
    b16 = hc.pack_weight(wt, torch.bfloat16).float().view(
        chunks, 7, nt, 32, 4)
    want = wt.bfloat16().float()
    for lane in range(32):
        for reg in range(2):
            k, n = hc.b_fragment(lane, reg)
            for e in range(2):
                ch = torch.arange(chunks) * hc.B_CK + k + e
                got = b16[:, :, :, lane, 2 * reg + e]       # chunk, ky, nt
                for j in range(nt):
                    kx, o = divmod(j * 8 + n, co)
                    if kx < 7:
                        ref = torch.zeros(chunks, 7)
                        real = ch < c
                        ref[real] = want[o, ch[real], :, kx]
                    else:
                        ref = torch.zeros(chunks, 7)
                    torch.testing.assert_close(got[:, :, j], ref)


def _ldmatrix_map():
    """(m, k) -> element offset, within a halo row of the bf16 stage, of
    A[m][k] of m-tile 0 as the kernel's ldmatrix.x4 and the m16n8k16 A
    layout place it: register i of lane (g, t) is the word at column 2t
    of row g of matrix i, whose row address lane 8i + g gave."""
    from lama_tpu_torch.ops.kernels import head_conv as hc
    idx = np.full((16, 16), -1)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for reg in range(4):
            px, half = hc.ldmatrix_row(8 * reg + g)
            addr = 8 * hc.b_unit(px, half) + 2 * t
            m, k = hc.a_fragment(lane, reg)
            assert idx[m, k] == -1 and idx[m, k + 1] == -1
            idx[m, k], idx[m, k + 1] = addr, addr + 1
    assert (idx >= 0).all()
    return idx


def _b_map():
    """(k, n) -> (lane, element) of the packed B fragment."""
    from lama_tpu_torch.ops.kernels import head_conv as hc
    lanes, elems = np.full((16, 8), -1), np.full((16, 8), -1)
    for lane in range(32):
        for reg in range(2):
            k, n = hc.b_fragment(lane, reg)
            for e in range(2):
                assert lanes[k + e, n] == -1
                lanes[k + e, n], elems[k + e, n] = lane, 2 * reg + e
    assert (lanes >= 0).all()
    return lanes, elems


def _replay_head_bf16(x, weight, bias):
    """numpy model of reflect_conv.cu's bf16 instance: per tile and chunk,
    the ring stage's swizzled halo image (channels past C zero, 16
    channels a stage), A read through `_ldmatrix_map` for each halo row of
    each warp's rows, B from `pack_weight`'s fragments, D = A @ B per
    (row, ky, m-tile, n-tile) as the kernel's loop nests them; then the
    epilogue: each m-tile's D rows (placed by `d_fragment`) into the
    warp's ring of D_ROWS rows, the outputs of `epilogue_ranges` summed
    over their kx shifts from it, + bias, and the row's 16-byte and
    element stores, each output element written exactly once. x:
    (B, H, W, C) float64, weight (C_out, C, 7, 7) torch; returns (B, H, W,
    C_out) float64 (no final bf16 rounding)."""
    from lama_tpu_torch.ops.kernels import head_conv as hc
    bf = torch.bfloat16
    b, h, w, c = x.shape
    co = weight.shape[0]
    nt, rw = hc.n_tiles(co), hc.rows_per_warp(co)
    th, tw = hc.tile(bf, co)
    chunks = -(-c // hc.B_CK)
    wpk = hc.pack_weight(weight, bf).double().numpy().reshape(
        chunks, 7, nt, 32, 4)
    amap = _ldmatrix_map()
    blane, belem = _b_map()
    dp = hc.d_pitch(co)
    # the kernel writes accumulator (2 hh + e) of lane (g, tq) at D row
    # g + 8 hh, column 2 tq + e of its n-tile: d_fragment's place
    for lane in range(32):
        for reg in range(4):
            assert hc.d_fragment(lane, reg) == (
                lane // 4 + 8 * (reg // 2), 2 * (lane % 4) + reg % 2)
    out = np.full((b * h * w * co,), np.nan)
    written = np.zeros(out.shape, int)
    for img, r0, c0 in hc.out_tiles(bf, co, b, h, w):
        rows, cols = hc.halo_source(bf, co, r0, c0, h, w)
        acc = np.zeros((hc.WARPS, rw, hc.B_MT, 16, nt * 8))
        for k in range(chunks):
            stage = np.full((th + 6, 2 * hc.B_HALO_W, 8), np.nan)
            for hr in range(th + 6):
                for px in range(hc.B_HALO_W):
                    for half in range(2):
                        lo = k * hc.B_CK + 8 * half
                        stage[hr, hc.b_unit(px, half)] = (
                            x[img, rows[hr], cols[px], lo:lo + 8]
                            if lo < c else 0.0)
            flat = stage.reshape(th + 6, -1)
            bmat = wpk[k][:, :, blane, belem]          # ky, nt, k, n
            for warp in range(hc.WARPS):
                for hh in range(rw + 6):
                    arow = flat[warp * rw + hh]
                    a = [arow[amap + 16 * 16 * mt] for mt in range(hc.B_MT)]
                    for r in range(rw):
                        ky = hh - r
                        if not 0 <= ky < 7:
                            continue
                        for j in range(nt):
                            for mt in range(hc.B_MT):
                                acc[warp, r, mt, :, j * 8:j * 8 + 8] += \
                                    a[mt] @ bmat[ky, j]
        valid = min(tw, w - c0) * co
        for warp in range(hc.WARPS):
            for r in range(rw):
                row = r0 + warp * rw + r
                if row >= h:
                    break
                e0 = ((img * h + row) * w + c0) * co
                ph = e0 % 8
                st = np.full(ph + tw * co, np.nan)
                ring = np.full((hc.D_ROWS, dp), np.nan)
                for mt, (x0, x1) in enumerate(hc.epilogue_ranges()):
                    for j in range(16):
                        ring[(16 * mt + j) % hc.D_ROWS, :nt * 8] = \
                            acc[warp, r, mt, j]
                    for p in range(x0 * co, x1 * co):
                        xo, oc = divmod(p, co)
                        total = sum(ring[(xo + kx) % hc.D_ROWS, kx * co + oc]
                                    for kx in range(7))
                        if p < valid:
                            st[ph + p] = total + bias[oc]
                lo, hi = (ph + 7) & ~7, (ph + valid) & ~7
                stored = [s for lane in range(32)
                          for v in range(lo + 8 * lane, hi - 7, 256)
                          for s in range(v, v + 8)]
                stored += [s for s in range(ph, ph + valid)
                           if s < lo or s >= hi]
                for s in stored:
                    out[e0 - ph + s] = st[s]
                    written[e0 - ph + s] += 1
    assert (written == 1).all()
    return out.reshape(b, h, w, co)


@pytest.mark.parametrize('b,c,co,h,w', [
    (1, 16, 3, 19, 61),     # two column tiles, partial tiles on both sides
    (2, 8, 1, 8, 9),        # C = 8: the chunk's upper half zero-filled
    (1, 24, 8, 9, 60),      # C_out 8 (7 n-tiles, one row a warp), C % 16
    (1, 64, 3, 17, 8),      # the head's C = 64, W = 8
])
def test_head_bf16_replay_matches_the_conv(b, c, co, h, w):
    """The bf16 kernel's design replayed in numpy (`_replay_head_bf16`) on
    bf16 values equals the plain reflect conv of the same values in
    float64 (rtol 1e-9: the replay only reorders sums)."""
    rng = np.random.RandomState(b + c + co + h + w)
    xb = torch.from_numpy(rng.rand(b, c, h, w).astype(np.float32)).bfloat16()
    wb = torch.from_numpy(
        (rng.randn(co, c, 7, 7) * 0.1).astype(np.float32)).bfloat16()
    bias = rng.randn(co)
    out = _replay_head_bf16(xb.double().permute(0, 2, 3, 1).numpy(),
                            wb.float(), bias)
    ref = trc.reflect_conv_plain(xb.double(), wb.double(),
                                 torch.from_numpy(bias))
    np.testing.assert_allclose(out, ref.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-9, atol=1e-9)


def test_head_routes_to_reflect_conv_cu():
    """The head wrapper's CUDA route in both dtypes is head_conv's launch
    of reflect_conv.cu; a CPU tensor takes the plain version."""
    import inspect

    from lama_tpu_torch.ops.kernels import head_conv as hc
    _, _, bf16, fp32 = trc.ROUTES['reflect_out_conv7x7']
    assert bf16 is hc.head_conv_reflect and fp32 is hc.head_conv_reflect
    assert "'reflect_out_conv7x7'" in inspect.getsource(
        trc.reflect_out_conv7x7)
    assert "_build.load('reflect_conv').lama_reflect_out_conv7x7" in \
        inspect.getsource(hc._launcher)


def test_chip_smoke_head_bound_at_the_served_batch():
    """chip_smoke.py's bound of the served head, (16, 64, 512, 512) -> 3
    with a bias: bf16 by its bytes (input, output, weight and bias once at
    3.35 TB/s), 0.168 ms; fp32 by its FMA (2 * 49 * 64 * 3 FLOP a pixel at
    67 TFLOP/s), 1.178 ms."""
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    args = (torch.empty(16, 64, 512, 512, device='meta'),
            torch.empty(3, 64, 7, 7, device='meta'),
            torch.empty(3, device='meta'))
    ms, by = chip_smoke.bound('reflect_out_conv7x7', 'head_b16', args, 'bf16')
    assert by == 'bytes' and ms == pytest.approx(0.1678, rel=1e-3)
    ms, by = chip_smoke.bound('reflect_out_conv7x7', 'head_b16', args, 'fp32')
    assert by == 'operations' and ms == pytest.approx(1.1776, rel=1e-3)


def test_head_conv_parts_switch_off_one_part_each(tmp_path):
    """Each part of the head's parts tool (lama_tpu_torch/tools/
    head_conv_parts.py) edits the current source exactly once, so the
    tool stays in step with the kernel; its copies land under the tree's
    git-ignored _scratch/ with that edit."""
    from lama_tpu_torch.tools import head_conv_parts as hp
    src = _head_source()
    csrc = tmp_path / 'lama_tpu_torch' / 'csrc'
    csrc.mkdir(parents=True)
    (csrc / 'reflect_conv.cu').write_text(src)
    roots = hp.make_copies(str(tmp_path))
    assert len(roots) == len(hp.PARTS) == 3
    for name, root in zip(hp.PARTS, roots):
        assert root == str(tmp_path / '_scratch' / 'head_parts' / name)
        with open(os.path.join(root, hp.SOURCE)) as f:
            text = f.read()
        assert text == hp.part_source(src, name) != src
        for _, new in hp.PARTS[name]:
            assert text.count(new) == 1
    with pytest.raises(ValueError, match='exactly once'):
        hp.part_source('', 'noepi')
