"""Eval-mode FourierUnit: CUDA kernel and its plain version (and the plain
unit with any mix of its spectrum, `spectral_unit`, which train mode and
the options off the kernel use).

Counterpart of the TPU kernel lama_tpu/ops/pallas/fourier_unit.py::
fused_fourier_unit (fourier_unit.py:130), with `planar_params` for its
`_planar_params` (:54): the eval-mode BN folded into the 1x1 spectral conv and
the reference's interleaved [re_0, im_0, re_1, ...] channels permuted to
planar [re_* | im_*], once per module.

The kernel (lama_tpu_torch/csrc/fourier_unit.cu) runs the unit as five
launches of one register-tiled, cp.async-staged fp32 SIMT GEMM, templated
on its tile height: real DFT along W, complex DFT along H, the folded 1x1
conv + bias + ReLU, inverse DFT along H, inverse real DFT along W, each
with the batch merged into N. The DFTs are matmuls with twiddle tables, as
in lama_tpu/ops/spectral.py; no cuFFT or cuBLAS. The spectrum keeps its
frequencies in `freq_order`, so the W-DFT computes only the W rows that a
real input can make non-zero (and writes the others as zeros) and the
W-iDFT reads only those. `_stage_plan` holds every stage's shapes, index
splits, tile and 16-byte-run flags, so the CPU tests can replay the plan in
numpy; `_launch_plan` keeps its ctypes structures per shape. Input NCHW
float32 or bfloat16 (any memory format); output float32, channels-last, as
the TPU kernel's output is float32; the arithmetic is fp32 for either input
type.

`store_bf16` (lama_tpu's spectral_bf16_store, lama_tpu/ops/spectral.py:
67-96): the four DFT stages round their sums to bf16 and store them so
(the spectra between launches and the output, which is then bf16); the
conv stage reads the bf16 spectrum and writes fp32; the sums stay fp32. As
in lama_tpu it acts only where its operands are bf16 (a bf16 input) and
where its DFT path runs, max(H, W) <= 256 (spectral.py:252-254); elsewhere
the unit is the one without it. The plain version rounds at the same four
points.

`norm` is torch.fft's ('ortho', the default, 'backward' or 'forward'): the
kernel's twiddle tables carry its scales (`twiddles_np`), so its
arithmetic is the same for every norm. A unit wider than the kernel's
envelope (`kernel_fits` false, max(H, W) > 256) takes `fourier_unit_fft`,
torch.fft and one 1x1 conv, as lama_tpu's FourierUnit takes jnp.fft there.

The wrapper calls the registered op `lama_tpu_torch::fused_fourier_unit`
(library.py; the folded weights are op inputs), which launches the kernel
on a CUDA tensor and computes the plain version on a CPU one; a CPU call
that needs a gradient takes the plain version itself. When a gradient is
needed on the card, the op runs inside `_autograd.differentiable`: its
backward is the VJP of `fourier_unit_plain` recomputed on the saved inputs,
with respect to x and the conv and BN parameters. The TPU kernel has no VJP at all (the JAX
package runs it only outside training, models/ffc.py:196-210), so there is
no backward kernel to port.
"""
import ctypes
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from .. import spectral
from ..precision import widen
from . import _build
from ._autograd import differentiable, needs_grad

MAX_SIDE = 256   # the TPU kernel's envelope, max(H, W) <= 256
NORMS = ('ortho', 'backward', 'forward')


def kernel_fits(h: int, w: int) -> bool:
    """Whether a unit of side h x w takes the kernel: max(H, W) <=
    MAX_SIDE, as lama_tpu's `use_dft_for` (ops/spectral.py:252-254) keeps
    its DFT path there and takes jnp.fft past it. A FourierUnit consults
    this before any launch and runs `fourier_unit_fft` past it."""
    return max(h, w) <= MAX_SIDE


def check_norm(norm: str) -> str:
    if norm not in NORMS:
        raise ValueError(f'fft norm {norm!r}: expected one of {NORMS}')
    return norm


def stores_bf16(x, store_bf16: bool) -> bool:
    """Whether `store_bf16` acts on a unit with input x: a bf16 input that
    `kernel_fits`, lama_tpu's DFT path (spectral.py:93-96, :252-254)."""
    return (bool(store_bf16) and x.dtype == torch.bfloat16
            and kernel_fits(*x.shape[-2:]))


def _eval_bn(bn_weight, bn_bias, bn_mean, bn_var, eps):
    def norm(y):
        return F.batch_norm(y, bn_mean.to(y.dtype), bn_var.to(y.dtype),
                            bn_weight.to(y.dtype), bn_bias.to(y.dtype), False,
                            0.0, eps)
    return norm


def fourier_unit_plain(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var,
                       eps: float = 1e-5, store_bf16: bool = False,
                       norm: str = 'ortho'):
    """Plain version, in the reference's form (reference ffc.py:76-113):
    rfft2 -> interleave re/im per channel -> 1x1 conv -> eval BN -> ReLU
    -> irfft2, all in float32, with torch.fft's `norm` ('ortho',
    'backward' or 'forward'). Returns float32 NCHW; bf16 where
    `store_bf16` acts (`stores_bf16`), which rounds the outputs of the four
    DFT stages (W, H, H inverse, W inverse) to bf16."""
    return spectral_unit(
        x, mixer(conv_weight, _eval_bn(bn_weight, bn_bias, bn_mean, bn_var,
                                       eps)),
        norm, stores_bf16(x, store_bf16))


def fourier_unit_fft(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var,
                     eps: float = 1e-5, norm: str = 'ortho'):
    """The eval unit past the kernel's envelope (`kernel_fits` false):
    torch.fft (cuFFT on the card) and one 1x1 conv, float32, the
    counterpart of lama_tpu's jnp.fft branch (models/ffc.py:229-231,
    :324-326), which its FourierUnit takes there. No `store_bf16`: lama_tpu
    rounds only on its DFT path. Counts its calls in `calls`. Returns
    float32 NCHW."""
    fourier_unit_fft.calls += 1
    return spectral_unit(
        x, mixer(conv_weight, _eval_bn(bn_weight, bn_bias, bn_mean, bn_var,
                                       eps)), norm)


fourier_unit_fft.calls = 0


def mixer(conv_weight, bn, groups: int = 1):
    """The unit's mix of its interleaved spectrum: the 1x1 conv (float32,
    `groups`), the norm `bn` and the ReLU."""
    def mix(y):
        return torch.relu(bn(F.conv2d(y, conv_weight.to(y.dtype),
                                      groups=groups)))
    return mix


def spectral_unit(x, mix, norm: str = 'ortho', store_bf16: bool = False,
                  ffc3d: bool = False):
    """Any FourierUnit in plain PyTorch (lama_tpu/models/ffc.py:211-330):
    the real FFT of NCHW x over (H, W), or over (C, H, W) with `ffc3d`,
    re and im interleaved per channel ((B, 2C, H, Wf) float32), `mix` of
    that ((B, 2C', H, Wf)), and its inverse, float32 (the spectral path
    computes in float32, float64 for a float64 input). With store_bf16 the
    outputs of the W-DFT, H-DFT, H-iDFT and W-iDFT are rounded to bf16 one
    axis at a time, as the kernel's launches store them, and the result is
    bf16 (not with ffc3d: lama_tpu rounds only on its DFT path)."""
    b, c, h, w = x.shape
    xf = widen(x)
    if store_bf16:
        def stored(z):
            return z.real.bfloat16().float(), z.imag.bfloat16().float()

        re, im = stored(torch.fft.rfft(xf, dim=-1, norm=norm))
        re, im = stored(torch.fft.fft(torch.complex(re, im), dim=-2,
                                      norm=norm))
    elif ffc3d:
        f = torch.fft.rfftn(xf, dim=(-3, -2, -1), norm=norm)
        re, im = f.real, f.imag
    else:
        re, im = spectral.rfft2(xf, norm)
    y = mix(torch.stack([re, im], dim=2).reshape(b, 2 * c, h, -1))
    y = y.reshape(b, -1, 2, h, y.shape[-1])
    if store_bf16:
        re, im = stored(torch.fft.ifft(torch.complex(y[:, :, 0], y[:, :, 1]),
                                       dim=-2, norm=norm))
        return spectral.irfft_w(re, im, w, norm).bfloat16()
    return spectral.irfftn(y[:, :, 0], y[:, :, 1],
                           (c, h, w) if ffc3d else (h, w), norm)


def planar_perm(c: int, device=None) -> torch.Tensor:
    """Planar index p = j*C + c -> interleaved index 2c + j."""
    p = torch.arange(2 * c, device=device)
    return 2 * (p % c) + p // c


@torch.no_grad()
def planar_params(conv_weight, bn_weight, bn_bias, bn_mean, bn_var,
                  eps: float = 1e-5):
    """Fold eval-mode BN into the (2C', 2C, 1, 1) spectral conv and permute
    interleaved -> planar. Returns (W (2C, 2C'), bias (2C',)), float32, on
    the weight's device: y_planar = x_planar @ W + bias."""
    wt = conv_weight[:, :, 0, 0].float().t()                     # (2C, 2C')
    scale = bn_weight.float() / torch.sqrt(bn_var.float() + eps)
    bias = bn_bias.float() - bn_mean.float() * scale
    wt = wt * scale[None, :]
    dev = wt.device
    perm_in = planar_perm(wt.shape[0] // 2, dev)
    perm_out = planar_perm(wt.shape[1] // 2, dev)
    return (wt[perm_in][:, perm_out].contiguous(),
            bias[perm_out].contiguous())


# DFT matrices: copies of lama_tpu/ops/spectral.py::_rdft_mats, _dft_mats and
# _irdft_mats (spectral.py:28-64) with their scales by norm (and the
# H-iDFT's, lama_tpu/ops/pallas/fourier_unit.py:142-146), computed in
# float64. 'ortho' and 'backward' scale as lama_tpu does; 'forward' as
# torch.fft does (1/n forward, 1 inverse): lama_tpu's DFT matrices scale it
# as 'backward' (spectral.py:34, :45, :61), which its jnp.fft path does not.
def forward_scale(n: int, norm: str) -> float:
    return {'ortho': n ** -0.5, 'backward': 1.0, 'forward': 1.0 / n}[norm]


def inverse_scale(n: int, norm: str) -> float:
    return {'ortho': n ** -0.5, 'backward': 1.0 / n, 'forward': 1.0}[norm]


def _rdft_mats(n, norm='ortho'):
    ang = -2.0 * np.pi * np.arange(n)[:, None] * np.arange(n // 2 + 1)[None] / n
    s = forward_scale(n, norm)
    return np.cos(ang) * s, np.sin(ang) * s                         # (n, nf)


def _dft_mats(n):
    """The unscaled complex DFT (n, n)."""
    ang = -2.0 * np.pi * np.arange(n)[:, None] * np.arange(n)[None] / n
    return np.cos(ang), np.sin(ang)


def _irdft_mats(n, norm='ortho'):
    nf = n // 2 + 1
    ang = 2.0 * np.pi * np.arange(nf)[:, None] * np.arange(n)[None] / n
    wgt = np.full((nf, 1), 2.0)
    wgt[0] = 1.0
    if n % 2 == 0:
        wgt[-1] = 1.0
    s = inverse_scale(n, norm)
    return np.cos(ang) * wgt * s, -np.sin(ang) * wgt * s              # (nf, n)


# The kernel's constants (csrc/fourier_unit.cu; tests/test_torch_kernels.py
# checks that the source agrees)
THREADS = 256               # 8 x 8 outputs a thread: BM * BN = 16384
OUTPUTS_PER_THREAD = 64
BK = 16                     # k per pipeline stage
A_PAD = 4                   # an A stage's row pitch is BK + A_PAD floats
STAGES = 3                  # pipeline ring depth
SMEM_LIMIT = 232448         # shared memory of one block, bytes
MAX_ZERO_ROWS = 2           # Im at f = 0 and at f = W / 2
NO_SPLIT = 1 << 30
TILE_ROWS = (128, 64, 32, 16)   # the kernel's instances (BM)
MAX_SPLITS = 4              # K splits of a stage (split_count)
SPLIT_SLACK = 0.05          # take the fewest splits within 5% of the best
SPLIT_GAIN = 0.9            # and split only for 10% less time than unsplit
A_BF16_BM = 128             # the tile height of a stage with a bf16 A
STAGE_NAMES = ('W-DFT', 'H-DFT', 'conv', 'H-iDFT', 'W-iDFT')


def tile_cols(bm: int) -> int:
    """BN of the instance with BM = bm."""
    return THREADS * OUTPUTS_PER_THREAD // bm


def tile_rows(m: int, n: int) -> int:
    """The block tile height (BM) of a stage with m x n outputs: the
    instance whose whole tiles cover the least area, ties to the larger
    BM."""
    def area(bm):
        bn = tile_cols(bm)
        return -(-m // bm) * bm * (-(-n // bn) * bn)
    return min(TILE_ROWS, key=lambda bm: (area(bm), -bm))


def split_count(tiles: int, chunks: int, sms: int) -> int:
    """K splits of a stage of `tiles` tiles and `chunks` BK-deep stages on a
    card of `sms` SMs (one block a SM): each of the s runs of a tile is a
    work unit, and a stage takes about ceil(tiles s / sms) / s tile times
    (the rounds of the busiest SM), plus the reduction of s partial
    planes. The fewest splits within SPLIT_SLACK of the best, up to
    MAX_SPLITS and one stage a run; none unless that cuts the rounds by
    SPLIT_GAIN: a grid under one wave (batch 1 at 63 x 48) or one that
    leaves most of a last round idle (at 125 x 95, and 128^2 and batch
    4)."""
    def rounds(s):
        return -(-tiles * s // sms) / s
    cands = range(1, min(MAX_SPLITS, chunks) + 1)
    best = min(rounds(s) for s in cands)
    s = next(s for s in cands if rounds(s) <= best * (1 + SPLIT_SLACK))
    return s if rounds(s) <= SPLIT_GAIN * rounds(1) else 1


def stage_bytes(bm: int, elem_bytes: int = 4) -> int:
    """Shared memory of one pipeline stage: A (bm x BK at pitch BK + A_PAD,
    fp32) and B (BK x BN, elem_bytes each)."""
    return bm * (BK + A_PAD) * 4 + BK * tile_cols(bm) * elem_bytes


def thread_tile(tid: int, bm: int):
    """(row group g, column group t) of thread `tid`: its rows are g, g +
    RG, .., g + 7 RG (RG = bm / 8), its columns 4t .. 4t + 3 and BN / 2 +
    4t .. + 3. A warp is WR x WC groups (4 x 8; 2 x 16 at RG
    = 2), a quarter-warp one row group's 8 consecutive column groups."""
    rg = bm // 8
    wr = min(rg, 4)
    wc = 32 // wr
    warps_n = THREADS // rg // wc
    lane, warp = tid % 32, tid // 32
    return ((warp // warps_n) * wr + lane // wc,
            (warp % warps_n) * wc + lane % wc)


def pitch(n: int) -> int:
    """A table row of n floats padded to whole 16-byte runs."""
    return -(-n // 4) * 4


def freq_order(w: int) -> np.ndarray:
    """The frequencies of a spectrum row in memory order: 1 .. Wf - 1, then
    0. The rows that are zero for a real input (Im at f = 0, and Im at f =
    W / 2 for even W) are then the last 2 Wf - W of a (b, h) panel
    [re | im]."""
    return np.r_[np.arange(1, w // 2 + 1), 0]


def twiddles_np(h: int, w: int, pad: bool = True, norm: str = 'ortho'):
    """The four twiddle tables of the stage plan for torch.fft's `norm`
    (the forward tables carry its forward scale, the inverse ones its
    inverse scale; the kernel itself scales nothing), float32, each row
    padded with zeros to `pitch` floats (pad=False: unpadded):
    tw_f (W, W): row r is spectrum row r (of [re | im] in `freq_order`) of
    the real W-DFT, the first W rows only; tw_h (2H, 2H): the complex H-DFT
    as a real block matrix over [re | im]; tw_ih (2H, 2H): its inverse;
    tw_iw (W, W): the inverse real W-DFT, reading spectrum rows 0 .. W - 1
    (the rows past them weigh sin(0) and sin(pi n))."""
    wr, wi = _rdft_mats(w, norm)
    dr, di = _dft_mats(h)
    hr, hi = dr * forward_scale(h, norm), di * forward_scale(h, norm)
    ihr, ihi = dr.T * inverse_scale(h, norm), -di.T * inverse_scale(h, norm)
    cr, ci = _irdft_mats(w, norm)
    order = freq_order(w)
    fwd = np.concatenate([wr.T[order], wi.T[order]], axis=0)       # (2Wf, W)
    inv = np.concatenate([cr.T[:, order], ci.T[:, order]], axis=1)  # (W, 2Wf)
    tabs = dict(tw_f=fwd[:w], tw_h=np.block([[hr.T, -hi.T], [hi.T, hr.T]]),
                tw_ih=np.block([[ihr.T, -ihi.T], [ihi.T, ihr.T]]),
                tw_iw=inv[:, :w])
    out = {}
    for k, v in tabs.items():
        # C order: the kernel reads them through raw pointers
        t = np.zeros((v.shape[0], pitch(v.shape[1]) if pad else v.shape[1]),
                     np.float32)
        t[:, :v.shape[1]] = v
        out[k] = t
    return out


@functools.lru_cache(maxsize=8)
def _twiddles(h: int, w: int, norm: str, device: torch.device):
    return {k: torch.from_numpy(v).to(device).contiguous()
            for k, v in twiddles_np(h, w, norm=norm).items()}


def vec_ok(row, col, n_rows: int, n_cols: int, ev: int) -> bool:
    """Whether an operand (row and column splits, n_rows x n_cols, ev
    elements a 16-byte run) takes the kernel's 16-byte copies: every run of
    ev columns from a multiple of ev lies in one split segment of
    consecutive elements and starts at a multiple of ev elements (16-byte
    aligned on an aligned buffer)."""
    d, hi, lo = col
    if lo != 1 or (d < n_cols and (d % ev or hi % ev)):
        return False
    d, hi, lo = row
    return lo % ev == 0 and (d >= n_rows or hi % ev == 0)


def _stage_plan(b: int, h: int, w: int, c: int, co: int,
                x_bf16: bool = False, pad: bool = True, sms: int = 0,
                store_bf16: bool = False):
    """The five GEMM launches of one unit, the batch merged into N. Each
    operand is (buffer, row_split, col_split, vec), a split (d, hi, lo)
    mapping index i to (i // d) * hi + (i % d) * lo, and `vec` whether it
    takes 16-byte runs (`vec_ok`). Buffers: x (B,H,W,C) NHWC; s0/s1
    spectra laid out (B, H, [re|im], Wf, C), frequencies in `freq_order`;
    wp (2C, 2C'), the planar weight; out (B, H, W, C') NHWC; the twiddle
    tables at row pitch `pitch` (pad=False: unpadded). `bm` is the stage's
    tile height (`tile_rows`), `splits` its K splits on a card of `sms`
    SMs (`split_count`; 1 for sms = 0); the W-DFT writes its last
    `zero_rows` spectrum rows as zeros. Each operand's element type is in
    `types` ('x' bf16 for a bf16 input; with store_bf16 the W-DFT, H-DFT,
    H-iDFT and W-iDFT outputs, and their readers, bf16)."""
    wf = w // 2 + 1

    def rows(stride):
        return (NO_SPLIT, 0, stride)

    def tab(n):
        return rows(pitch(n) if pad else n)

    col = rows(1)
    spec_in = (h, wf * c, 2 * wf * c)      # row (ri, y) of a (B,) spectrum
    spec_out = (h, wf * co, 2 * wf * co)
    stages = [
        dict(M=w, N=b * h * c, K=w,                             # W-DFT
             a=('tw_f', tab(w), col), b=('x', rows(c), (c, w * c, 1)),
             out=('s0', rows(c), (c, 2 * wf * c, 1)), zero_rows=2 * wf - w),
        dict(M=2 * h, N=b * wf * c, K=2 * h,                    # H-DFT
             a=('tw_h', tab(2 * h), col),
             b=('s0', spec_in, (wf * c, h * 2 * wf * c, 1)),
             out=('s1', spec_in, (wf * c, h * 2 * wf * c, 1))),
        dict(M=b * h * wf, N=2 * co, K=2 * c,                   # 1x1 conv
             a=('s1', (wf, 2 * wf * c, c), (c, wf * c, 1)),
             b=('wp', rows(2 * co), col),
             out=('s0', (wf, 2 * wf * co, co), (co, wf * co, 1)),
             bias=True, relu=True),
        dict(M=2 * h, N=b * wf * co, K=2 * h,                   # H-iDFT
             a=('tw_ih', tab(2 * h), col),
             b=('s0', spec_out, (wf * co, h * 2 * wf * co, 1)),
             out=('s1', spec_out, (wf * co, h * 2 * wf * co, 1))),
        dict(M=w, N=b * h * co, K=w,                            # W-iDFT
             a=('tw_iw', tab(w), col),
             b=('s1', rows(co), (co, 2 * wf * co, 1)),
             out=('out', rows(co), (co, w * co, 1))),
    ]
    for name, st in zip(STAGE_NAMES, stages):
        m, n, k = st['M'], st['N'], st['K']
        # bf16 operands: x, and with store_bf16 the DFT stages' outputs
        # (s0 after the W-DFT, s1, the unit's output) and their readers
        types = dict(a=store_bf16 and name == 'conv',
                     b=(x_bf16 if name == 'W-DFT' else
                        store_bf16 and name in ('H-DFT', 'W-iDFT')),
                     out=store_bf16 and name != 'conv')
        # the kernel has a bf16 A (the stored spectrum) at one tile height
        bm = A_BF16_BM if types['a'] else tile_rows(m, n)
        tiles = -(-m // bm) * -(-n // tile_cols(bm))
        st.update(stage=name, bm=bm, types=types,
                  splits=split_count(tiles, -(-k // BK), sms) if sms else 1,
                  a=st['a'] + (vec_ok(*st['a'][1:], m, k,
                                      8 if types['a'] else 4),),
                  b=st['b'] + (vec_ok(*st['b'][1:], k, n,
                                      8 if types['b'] else 4),),
                  out=st['out'] + (vec_ok(*st['out'][1:], m, n, 4),))
        st.setdefault('bias', False)
        st.setdefault('relu', False)
        st.setdefault('zero_rows', 0)
    return stages


class _Split(ctypes.Structure):
    _fields_ = [('d', ctypes.c_int), ('hi', ctypes.c_longlong),
                ('lo', ctypes.c_longlong)]


class _View(ctypes.Structure):
    _fields_ = [('p', ctypes.c_void_p), ('bf16', ctypes.c_int),
                ('vec', ctypes.c_int), ('row', _Split), ('col', _Split)]


class _Out(ctypes.Structure):
    _fields_ = [('p', ctypes.c_void_p), ('vec', ctypes.c_int),
                ('row', _Split), ('col', _Split), ('bias', ctypes.c_void_p),
                ('relu', ctypes.c_int), ('zero_rows', ctypes.c_int),
                ('bf16', ctypes.c_int)]


# lama_fu_gemm(M, N, K, bm, splits, A*, B*, C*, ws, stream)
ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5


def workspace_floats(st) -> int:
    """fp32 partial sums of a split stage: splits x M x (N rounded up to
    4); 0 unsplit."""
    return 0 if st['splits'] == 1 else st['splits'] * st['M'] * pitch(st['N'])


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1)
def _gemm_fn():
    fn = _build.load('fourier_unit').lama_fu_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    return fn


def _gemm(stage: str, *args):
    """One stage's launch (lama_fu_gemm's arguments); raises on a CUDA
    error."""
    err = _gemm_fn()(*args)
    if err != 0:
        raise RuntimeError(f'fused_fourier_unit: CUDA launch of the {stage} '
                           f'stage failed with error {err}')


@functools.lru_cache(maxsize=16)
def _launch_plan(b: int, h: int, w: int, c: int, co: int, x_bf16: bool,
                 device: torch.device, sms: int, store_bf16: bool = False,
                 norm: str = 'ortho'):
    """One shape's five launches on a card of `sms` SMs as ctypes
    structures (the per-call buffers' pointers are filled in at each call),
    its twiddle tables for `norm` and the workspace its split stages need:
    [(stage, (M, N, K, bm, splits), A, B, C, [(struct, buffer, vec)],
    bias)], tables, workspace floats."""
    tabs = _twiddles(h, w, norm, device)
    launches = []
    plan = _stage_plan(b, h, w, c, co, x_bf16, sms=sms,
                       store_bf16=store_bf16)
    for st in plan:
        structs = []

        def view(spec, cls, **extra):
            name, row, col, vec = spec
            v = cls(None, vec=int(vec), row=_Split(*row), col=_Split(*col),
                    **extra)
            structs.append((v, name, vec))
            return v

        a = view(st['a'], _View, bf16=int(st['types']['a']))
        bv = view(st['b'], _View, bf16=int(st['types']['b']))
        out = view(st['out'], _Out, relu=int(st['relu']),
                   zero_rows=st['zero_rows'], bf16=int(st['types']['out']))
        launches.append((st['stage'], (st['M'], st['N'], st['K'], st['bm'],
                                       st['splits']),
                         a, bv, out, structs, st['bias']))
    return launches, tabs, max(workspace_floats(st) for st in plan)


_launch_lock = threading.Lock()   # the cached structures are filled per call


def fused_fourier_unit(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var,
                       eps: float = 1e-5, planar=None,
                       store_bf16: bool = False, norm: str = 'ortho'):
    """Eval-mode FourierUnit with torch.fft's `norm` ('ortho', 'backward'
    or 'forward'). x: (B, C, H, W) with max(H, W) <= MAX_SIDE
    (`kernel_fits`); conv_weight: (2C', 2C, 1, 1) in the reference's
    interleaved order; BN over 2C'. `planar`: the (W, bias) of
    `planar_params`, when the caller keeps them; else computed here. The
    forward reads them; a gradient flows through the plain version's
    parameters. Runs the registered op `lama_tpu_torch::fused_fourier_unit`
    (library.py: the kernel on a CUDA tensor, the plain version on a CPU
    one). Returns float32 (B, C', H, W); bf16 where `store_bf16` acts
    (`stores_bf16`)."""
    check_norm(norm)
    store_bf16 = stores_bf16(x, store_bf16)
    inputs = (x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var)
    plain = functools.partial(fourier_unit_plain, eps=eps,
                              store_bf16=store_bf16, norm=norm)
    if not x.is_cuda and needs_grad(*inputs):
        return plain(*inputs)
    if planar is None:
        planar = planar_params(*inputs[1:], eps)

    def op(*args):
        return torch.ops.lama_tpu_torch.fused_fourier_unit.default(
            *args, *planar, eps, store_bf16, norm)
    return differentiable(op, plain, *inputs)


def _launch(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var, eps, planar,
            store_bf16=False, norm='ortho'):
    """The kernel's five launches on CUDA tensors: the CUDA implementation
    of the registered op (library.py)."""
    b, c, h, w = x.shape
    co = conv_weight.shape[0] // 2
    check_norm(norm)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'fused_fourier_unit: dtype {x.dtype}')
    if tuple(conv_weight.shape) != (2 * co, 2 * c, 1, 1):
        raise ValueError(f'fused_fourier_unit: conv weight '
                         f'{tuple(conv_weight.shape)} for {c} channels')
    if not kernel_fits(h, w):
        raise ValueError(f'fused_fourier_unit: {h}x{w} exceeds {MAX_SIDE}')
    wp, bp = planar if planar is not None else planar_params(
        conv_weight, bn_weight, bn_bias, bn_mean, bn_var, eps)
    if (wp.device != x.device or tuple(wp.shape) != (2 * c, 2 * co)
            or wp.dtype != torch.float32 or bp.dtype != torch.float32
            or not (wp.is_contiguous() and bp.is_contiguous())):
        raise ValueError('fused_fourier_unit: planar params do not match x')
    wf = w // 2 + 1
    x = x.contiguous(memory_format=torch.channels_last)
    # s0 holds the W-DFT's output and the conv's (fp32); s1 the H-DFT's and
    # the H-iDFT's, bf16 with store_bf16
    spectrum = b * h * 2 * wf * max(c, co)
    s0 = torch.empty(spectrum, dtype=torch.float32, device=x.device)
    s1 = torch.empty(spectrum, dtype=torch.bfloat16 if store_bf16
                     else torch.float32, device=x.device)
    out = torch.empty((b, co, h, w), dtype=torch.bfloat16 if store_bf16
                      else torch.float32, device=x.device,
                      memory_format=torch.channels_last)
    launches, tabs, ws_floats = _launch_plan(
        b, h, w, c, co, x.dtype == torch.bfloat16, x.device,
        _sm_count(x.device), store_bf16, norm)
    ws = (torch.empty(ws_floats, dtype=torch.float32, device=x.device)
          if ws_floats else None)
    ptrs = {k: t.data_ptr() for k, t in tabs.items()}
    ptrs.update(x=x.data_ptr(), s0=s0.data_ptr(), s1=s1.data_ptr(),
                wp=wp.data_ptr(), out=out.data_ptr())
    with torch.cuda.device(x.device), _launch_lock:
        stream = torch.cuda.current_stream().cuda_stream
        for stage, dims, a, bv, o, structs, bias in launches:
            for struct, name, vec in structs:
                struct.p = ptrs[name]
                struct.vec = int(vec and ptrs[name] % 16 == 0)
            o.bias = bp.data_ptr() if bias else None
            _gemm(stage, *dims, ctypes.addressof(a), ctypes.addressof(bv),
                  ctypes.addressof(o), None if ws is None else ws.data_ptr(),
                  stream)
    return out


fused_fourier_unit.launches = 0
