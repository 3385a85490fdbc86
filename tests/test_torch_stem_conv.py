"""The stem conv (csrc/stem_conv.cu, ops/kernels/stem_conv.py) on the CPU.

- The wrapper's constants against the source's.
- The bf16 instance's fragment map (`stem_conv.a_fragment`, `b_fragment`,
  `d_fragment`), replayed in numpy on halos built as the kernel stages
  them (reflect-mapped pixels, channels zero-filled to the pitch, the last
  column zeros): every A operand the kernel loads is held to the unfold of
  the reflect-padded input, every padded k slot is shown to read inside
  the staged halo row, and the whole mma product, with B read from the
  packed weights, to the plain conv of the same values (float64, rtol
  1e-9: the replay only reorders sums).
- The stem's plain version at C = 4 against the JAX generator's own stem
  path, lama_tpu.ops.conv.conv2d(..., padding=3, padding_mode='reflect')
  on the CPU (the stem lies outside the Pallas envelope), fp32 rtol 1e-4.
- The envelope and the route: the stem's shapes go to stem_conv's launch
  in both dtypes, kernel 7's other shapes to halo_conv.cu.
The fp32 instance runs on the CPU in tests/test_torch_stem_conv_emulated.py;
both instances on the card in tests/test_torch_cuda.py and chip_smoke.py.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lama_tpu.ops.conv import conv2d as jax_conv2d
from lama_tpu_torch.ops import conv as tconv
from lama_tpu_torch.ops.kernels import _build
from lama_tpu_torch.ops.kernels import halo_conv as hc
from lama_tpu_torch.ops.kernels import stem_conv as sc
from lama_tpu_torch.ops.kernels.reflect_conv import reflect_conv_plain

torch.set_num_threads(1)


def _source():
    with open(_build.source_path('stem_conv')) as f:
        return f.read()


def test_source_constants_match_the_wrapper():
    src = _source()

    def const(name):
        m = re.search(rf'constexpr int [^;]*\b{name} = (\d+)', src)
        assert m, name
        return int(m.group(1))

    assert (const('KS'), const('PAD')) == (sc.KS, sc.PAD)
    assert (const('TILE_H'), const('TILE_W')) == (sc.TILE_H, sc.TILE_W)
    assert const('THREADS') == sc.THREADS and const('CO_MAX') == sc.CO_MAX
    assert const('RING') == sc.RING
    assert 'HALO_W = TILE_W + KS;' in src and sc.HALO_W == sc.TILE_W + sc.KS
    assert 'C > 8' in src and sc.MAX_C == 8
    # the bf16 plan's k row and weight pitch, as the Plan computes them
    assert 'KY = (KS * PITCH + 15) / 16 * 16' in src
    assert 'WPITCH = KS * KY + 8' in src
    assert [sc.ky_width(p) for p in (4, 8)] == [32, 64]
    assert [sc.weight_pitch(p) for p in (4, 8)] == [232, 456]
    # fp32 is full FMA: no TF32; bf16 the m16n8k16 mma; in _build's list
    assert 'tf32' not in re.sub(r'//.*', '', src).lower()
    assert 'mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32' in src
    assert 'stem_conv' in _build.SOURCES


def _halo(x, r0, c0, p):
    """The halo the kernel stages for the tile at (r0, c0) of one NHWC
    image x (numpy): HALO_H x HALO_W pixels of p channels."""
    h, w, c = x.shape
    rows, cols = sc.halo_source(r0, c0, h, w)
    halo = np.zeros((sc.HALO_H, sc.HALO_W, p), x.dtype)
    for j, col in enumerate(cols):
        if col is not None:
            halo[:, j, :c] = x[rows, col]
    return halo


def _a_map(p):
    """(step, m_tile, lane, reg) -> (m, k, offset) of every A load of one ky
    row."""
    return [(s, mt, lane, reg) + sc.a_fragment(lane, reg, s, mt, p)
            for s in range(sc.ky_width(p) // 16) for mt in range(2)
            for lane in range(32) for reg in range(4)]


# (B, C, H, W): pitch 4 (C = 4, 3) and 8 (C = 8, 6); partial tiles
REPLAY_CASES = [(1, 4, 11, 40), (2, 3, 8, 33), (1, 8, 9, 35), (1, 6, 4, 5)]


@pytest.mark.parametrize('b,c,h,w', REPLAY_CASES)
def test_bf16_a_fragments_replay_the_unfold(b, c, h, w):
    """Each (lane, register, k-step) A operand read from the staged halo
    equals the unfold of the reflect-padded input at its (pixel, ky, kx,
    c); channels past C read zeros; the padded k slots (k >= 7 p) read
    inside the ky's halo row, finite values; every (m, k) of a k-step is
    loaded exactly once."""
    rng = np.random.RandomState(c + h + w)
    x = rng.rand(b, h, w, c).astype(np.float32)
    p = sc.pitch(c)
    row = sc.halo_row(p)
    amap = _a_map(p)
    seen = {}
    for (s, mt, lane, reg, m, k, off) in amap:
        assert off >= 0 and off + 1 < row, (s, mt, lane, reg, off)
        key = (mt, m, k)
        assert key not in seen, key
        seen[key] = s
    assert len(seen) == 2 * 16 * sc.ky_width(p) // 2
    for img, r0, c0 in sc.out_tiles(b, h, w):
        xp = np.pad(x[img], ((3, 3), (3, 3), (0, 0)), mode='reflect')
        halo = _halo(x[img], r0, c0, p)
        for wr in range(sc.TILE_H):          # warp wr: output row r0 + wr
            if r0 + wr >= h:
                continue
            for ky in range(sc.KS):
                flat = halo[wr + ky].reshape(-1)
                for (s, mt, lane, reg, m, k, off) in amap:
                    col = c0 + m
                    for half in range(2):
                        kk, v = k + half, flat[off + half]
                        assert np.isfinite(v)
                        if kk >= sc.KS * p or col >= w:
                            continue   # zero weight, or an unstored pixel
                        kx, ch = divmod(kk, p)
                        want = xp[r0 + wr + ky, col + kx, ch] if ch < c else 0
                        assert v == want, (img, r0, c0, wr, ky, s, lane, reg)


@pytest.mark.parametrize('b,c,h,w', REPLAY_CASES)
@pytest.mark.parametrize('co', [64, 16])
def test_bf16_fragment_replay_matches_the_conv(b, c, h, w, co):
    """The bf16 kernel's product replayed through its fragment maps: A from
    the staged halo, B from `pack_weight`'s bf16 image, D placed by
    `d_fragment` as the epilogue stores it, plus the bias; held to the
    plain conv of the same bf16 values (float64)."""
    rng = np.random.RandomState(co + c + h)
    xb = torch.from_numpy(rng.rand(b, c, h, w).astype(np.float32)).bfloat16()
    wb = torch.from_numpy(rng.randn(co, c, 7, 7).astype(np.float32) * 0.1)
    bias = torch.from_numpy(rng.randn(co).astype(np.float32))
    wb = wb.bfloat16()
    p = sc.pitch(c)
    kw = sc.ky_width(p)
    wpk = sc.pack_weight(wb.float(), torch.bfloat16).double().numpy()
    assert wpk.size == sc.CO_MAX * sc.weight_pitch(p)
    x = xb.double().permute(0, 2, 3, 1).numpy()
    amap = _a_map(p)
    out = np.full((b, h, w, co), np.nan)
    for img, r0, c0 in sc.out_tiles(b, h, w):
        halo = _halo(x[img], r0, c0, p)
        for wr in range(min(sc.TILE_H, h - r0)):
            acc = np.zeros((2, 16, sc.CO_MAX))           # [mt][m][n]
            for ky in range(sc.KS):
                flat = halo[wr + ky].reshape(-1)
                a = np.zeros((2, 16, kw))
                for (s, mt, lane, reg, m, k, off) in amap:
                    a[mt, m - 16 * mt, k:k + 2] = flat[off:off + 2]
                bm = np.zeros((kw, sc.CO_MAX))
                for s in range(kw // 16):
                    for j in range(8):
                        for lane in range(32):
                            for reg in range(2):
                                k, n, off = sc.b_fragment(lane, reg, s, j, ky, p)
                                bm[k:k + 2, n] = wpk[off:off + 2]
                acc += a @ bm
            for mt in range(2):
                for j in range(8):
                    for lane in range(32):
                        for reg in range(4):
                            m, n = sc.d_fragment(lane, reg)
                            n += 8 * j
                            col = c0 + 16 * mt + m
                            if col < w and n < co:
                                out[img, r0 + wr, col, n] = \
                                    acc[mt, m, n] + bias[n].item()
    ref = reflect_conv_plain(xb.double(), wb.double(), bias.double())
    np.testing.assert_allclose(out, ref.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-9, atol=1e-9)


def test_pack_weight_layouts():
    """fp32 [ky][kx][c][n] and bf16 [n][ky * KY + kx * pitch + c], zero
    past C, C_out, 7 pitch and the row's end."""
    g = torch.Generator().manual_seed(3)
    for c, co in ((4, 64), (3, 16), (6, 48)):
        wt = torch.rand(co, c, 7, 7, generator=g) + 0.5
        p = sc.pitch(c)
        f32 = sc.pack_weight(wt, torch.float32).view(7, 7, p, sc.CO_MAX)
        torch.testing.assert_close(f32[:, :, :c, :co], wt.permute(2, 3, 1, 0))
        assert f32[:, :, c:].abs().sum() == 0 and f32[..., co:].abs().sum() == 0
        b16 = sc.pack_weight(wt, torch.bfloat16).float().view(
            sc.CO_MAX, sc.weight_pitch(p))
        kw = sc.ky_width(p)
        rows = b16[:, :7 * kw].view(sc.CO_MAX, 7, kw)
        want = wt.bfloat16().float().permute(0, 2, 3, 1)     # n, ky, kx, c
        got = rows[:co, :, :7 * p].reshape(co, 7, 7, p)
        torch.testing.assert_close(got[..., :c], want)
        assert got[..., c:].abs().sum() == 0
        assert rows[:, :, 7 * p:].abs().sum() == 0
        assert b16[co:].abs().sum() == 0 and b16[:, 7 * kw:].abs().sum() == 0


@pytest.mark.parametrize('b,h,w,bias', [(2, 16, 20, False), (1, 13, 9, True)])
def test_stem_plain_matches_the_jax_stem(b, h, w, bias):
    """The port's stem on the CPU (halo_conv_reflect_tiled's plain path, no
    launch) against lama_tpu.ops.conv.conv2d's reflect 7x7, the JAX
    generator's stem, fp32 rtol 1e-4 on the same numpy inputs."""
    rng = np.random.RandomState(h + w)
    x = rng.rand(b, h, w, 4).astype(np.float32)
    kern = (rng.randn(7, 7, 4, 64) * 0.1).astype(np.float32)
    bv = rng.randn(64).astype(np.float32) if bias else None
    ref = jax_conv2d(jnp.asarray(x), jnp.asarray(kern),
                     None if bv is None else jnp.asarray(bv),
                     padding=3, padding_mode='reflect')
    weight = torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    before = hc.halo_conv_reflect_tiled.launches
    out = hc.halo_conv_reflect_tiled(xt, weight,
                                     None if bv is None else torch.from_numpy(bv))
    assert hc.halo_conv_reflect_tiled.launches == before   # CPU: plain
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_stem_envelope_and_route():
    """The stems of both families at the serve, refine and train sides go
    to stem_conv's launch, in both dtypes; kernel 7's k3 s1, k3 s2 and k7
    s2 shapes and wider C or C_out to halo_conv.cu (no route)."""
    for h, w in ((512, 512), (256, 256), (1024, 1024), (1000, 760), (4, 4)):
        assert sc.supported(h, w, 4, 64, 7, 1)
        assert hc.tiled_route(h, w, 4, 64, 7, 1) is sc.stem_conv_reflect
    for c, co in ((1, 16), (3, 48), (8, 32), (5, 64)):
        assert hc.tiled_route(64, 64, c, co, 7, 1) is sc.stem_conv_reflect
    for args in ((96, 96, 16, 32, 3, 1), (255, 129, 32, 64, 3, 2),
                 (128, 128, 8, 24, 7, 2), (64, 64, 4, 64, 7, 2),
                 (64, 64, 9, 64, 7, 1), (64, 64, 4, 24, 7, 1),
                 (64, 64, 4, 128, 7, 1), (64, 64, 4, 8, 7, 1),
                 (3, 64, 4, 64, 7, 1), (64, 3, 4, 64, 7, 1)):
        assert not sc.supported(*args), args
        assert hc.tiled_route(*args) is None, args
    # ops/conv.py sends the stem to kernel 7's wrapper, whose route it is
    pick = tconv.kernel_for(torch.empty(1, 4, 256, 256),
                            torch.empty(64, 4, 7, 7), 1, 3, 1, 1, 'reflect')
    assert pick.func is hc.halo_conv_reflect_tiled
    assert pick.keywords == {'stride': 1}
