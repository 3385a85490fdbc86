"""Eval-mode FourierUnit: CUDA kernel and its plain version (and the plain
unit with any BN, which train mode uses).

Counterpart of the TPU kernel lama_tpu/ops/pallas/fourier_unit.py::
fused_fourier_unit (fourier_unit.py:130), with `planar_params` for its
`_planar_params` (:54): the eval-mode BN folded into the 1x1 spectral conv and
the reference's interleaved [re_0, im_0, re_1, ...] channels permuted to
planar [re_* | im_*], once per module.

The kernel (lama_tpu_torch/csrc/fourier_unit.cu) runs the unit as five
launches of one strided GEMM: real DFT along W, complex DFT along H, the
folded 1x1 conv + bias + ReLU, inverse DFT along H, inverse real DFT along W.
The DFTs are matmuls with twiddle tables, as in lama_tpu/ops/spectral.py; no
cuFFT or cuBLAS. `_stage_plan` holds every stage's shapes and strides, so
the CPU tests can replay the plan in numpy. Input NCHW float32 or bfloat16
(any memory format); output float32, channels-last, as the TPU kernel's
output is float32; the arithmetic is fp32 for either input type.

When a gradient is needed, the kernel runs inside
`_autograd.differentiable`: its backward is the VJP of
`fourier_unit_plain` recomputed on the saved inputs, with respect to x and
the conv and BN parameters. The TPU kernel has no VJP at all (the JAX
package runs it only outside training, models/ffc.py:196-210), so there is
no backward kernel to port.
"""
import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import spectral
from . import _build
from ._autograd import differentiable

MAX_SIDE = 256   # the TPU kernel's envelope, max(H, W) <= 256
_NO_SPLIT = 1 << 30


def fourier_unit_plain(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var,
                       eps: float = 1e-5):
    """Plain version, in the reference's form (reference ffc.py:76-113):
    rfft2 (ortho) -> interleave re/im per channel -> 1x1 conv -> eval BN ->
    ReLU -> irfft2, all in float32. Returns float32 NCHW."""
    return fourier_unit_with_norm(x, conv_weight, lambda y: F.batch_norm(
        y, bn_mean.float(), bn_var.float(), bn_weight.float(),
        bn_bias.float(), False, 0.0, eps))


def fourier_unit_with_norm(x, conv_weight, norm):
    """The plain FourierUnit with `norm` (a callable on the float32
    spectrum, e.g. a BatchNorm module in train mode) as its BN."""
    b, c, h, w = x.shape
    re, im = spectral.rfft2(x)                                    # (b,c,h,wf)
    y = torch.stack([re, im], dim=2).reshape(b, 2 * c, h, -1)
    y = torch.relu(norm(F.conv2d(y, conv_weight.to(y.dtype))))
    y = y.reshape(b, -1, 2, h, y.shape[-1])
    return spectral.irfft2(y[:, :, 0], y[:, :, 1], s=(h, w))


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
# _irdft_mats (spectral.py:28-64), ortho norm, computed in float64.
def _rdft_mats(n):
    ang = -2.0 * np.pi * np.arange(n)[:, None] * np.arange(n // 2 + 1)[None] / n
    return np.cos(ang) / np.sqrt(n), np.sin(ang) / np.sqrt(n)       # (n, nf)


def _dft_mats(n):
    ang = -2.0 * np.pi * np.arange(n)[:, None] * np.arange(n)[None] / n
    return np.cos(ang) / np.sqrt(n), np.sin(ang) / np.sqrt(n)       # (n, n)


def _irdft_mats(n):
    nf = n // 2 + 1
    ang = 2.0 * np.pi * np.arange(nf)[:, None] * np.arange(n)[None] / n
    wgt = np.full((nf, 1), 2.0)
    wgt[0] = 1.0
    if n % 2 == 0:
        wgt[-1] = 1.0
    return (np.cos(ang) * wgt / np.sqrt(n),
            -np.sin(ang) * wgt / np.sqrt(n))                        # (nf, n)


def twiddles_np(h: int, w: int):
    """The four twiddle tables of the stage plan, float32:
    tw_f (2Wf, W): rows [Re | Im] of the real W-DFT;
    tw_h (2H, 2H): the complex H-DFT as a real block matrix over [re | im];
    tw_ih (2H, 2H): its inverse; tw_iw (W, 2Wf): the inverse real W-DFT."""
    wr, wi = _rdft_mats(w)
    hr, hi = _dft_mats(h)
    ihr, ihi = hr.T, -hi.T
    cr, ci = _irdft_mats(w)
    tabs = dict(
        tw_f=np.concatenate([wr.T, wi.T], axis=0),
        tw_h=np.block([[hr.T, -hi.T], [hi.T, hr.T]]),
        tw_ih=np.block([[ihr.T, -ihi.T], [ihi.T, ihr.T]]),
        tw_iw=np.concatenate([cr.T, ci.T], axis=1))
    # C order: the kernel reads them through raw pointers, and concatenating
    # transposes would otherwise hand back column-major arrays
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in tabs.items()}


@functools.lru_cache(maxsize=8)
def _twiddles(h: int, w: int, device: torch.device):
    return {k: torch.from_numpy(v).to(device).contiguous()
            for k, v in twiddles_np(h, w).items()}


def _stage_plan(b: int, h: int, w: int, c: int, co: int):
    """The five GEMM launches of one unit. Each operand is
    (buffer, batch_stride, row_split, col_split), a split (d, hi, lo)
    mapping index i to (i // d) * hi + (i % d) * lo. Buffers: x (B,H,W,C)
    NHWC; s0/s1 spectra laid out (B, H, [re|im], Wf, C); wp (2C, 2C'), the
    planar weight; out (B, H, W, C') NHWC."""
    wf = w // 2 + 1

    def rows(stride):
        return (_NO_SPLIT, 0, stride)

    col = rows(1)
    spec_in = (h, wf * c, 2 * wf * c)      # row (ri, y) of a (B,) spectrum
    spec_out = (h, wf * co, 2 * wf * co)
    return [
        dict(M=2 * wf, N=c, K=w, batches=b * h,                # W-DFT
             a=('tw_f', 0, rows(w), col), b=('x', w * c, rows(c), col),
             out=('s0', 2 * wf * c, rows(c), col)),
        dict(M=2 * h, N=wf * c, K=2 * h, batches=b,            # H-DFT
             a=('tw_h', 0, rows(2 * h), col),
             b=('s0', h * 2 * wf * c, spec_in, col),
             out=('s1', h * 2 * wf * c, spec_in, col)),
        dict(M=b * h * wf, N=2 * co, K=2 * c, batches=1,       # 1x1 conv
             a=('s1', 0, (wf, 2 * wf * c, c), (c, wf * c, 1)),
             b=('wp', 0, rows(2 * co), col),
             out=('s0', 0, (wf, 2 * wf * co, co), (co, wf * co, 1)),
             bias=True, relu=True),
        dict(M=2 * h, N=wf * co, K=2 * h, batches=b,           # H-iDFT
             a=('tw_ih', 0, rows(2 * h), col),
             b=('s0', h * 2 * wf * co, spec_out, col),
             out=('s1', h * 2 * wf * co, spec_out, col)),
        dict(M=w, N=co, K=2 * wf, batches=b * h,               # W-iDFT
             a=('tw_iw', 0, rows(2 * wf), col),
             b=('s1', 2 * wf * co, rows(co), col),
             out=('out', w * co, rows(co), col)),
    ]


class _Split(ctypes.Structure):
    _fields_ = [('d', ctypes.c_int), ('hi', ctypes.c_longlong),
                ('lo', ctypes.c_longlong)]


class _View(ctypes.Structure):
    _fields_ = [('p', ctypes.c_void_p), ('bf16', ctypes.c_int),
                ('batch_stride', ctypes.c_longlong),
                ('row', _Split), ('col', _Split)]


class _Out(ctypes.Structure):
    _fields_ = [('p', ctypes.c_void_p), ('batch_stride', ctypes.c_longlong),
                ('row', _Split), ('col', _Split), ('bias', ctypes.c_void_p),
                ('relu', ctypes.c_int)]


def fused_fourier_unit(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var,
                       eps: float = 1e-5, planar=None):
    """Eval-mode FourierUnit (ortho norm). x: (B, C, H, W); conv_weight:
    (2C', 2C, 1, 1) in the reference's interleaved order; BN over 2C'.
    `planar`: the (W, bias) of `planar_params`, when the caller keeps them
    (the forward reads them; a gradient flows through the plain version's
    parameters). Returns float32 (B, C', H, W)."""
    if not x.is_cuda:
        return fourier_unit_plain(x, conv_weight, bn_weight, bn_bias, bn_mean,
                                  bn_var, eps)
    out = differentiable(
        functools.partial(_launch, eps=eps, planar=planar),
        functools.partial(fourier_unit_plain, eps=eps),
        x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var)
    fused_fourier_unit.launches += 1
    return out


def _launch(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var, eps, planar):
    b, c, h, w = x.shape
    co = conv_weight.shape[0] // 2
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'fused_fourier_unit: dtype {x.dtype}')
    if tuple(conv_weight.shape) != (2 * co, 2 * c, 1, 1):
        raise ValueError(f'fused_fourier_unit: conv weight '
                         f'{tuple(conv_weight.shape)} for {c} channels')
    if max(h, w) > MAX_SIDE:
        raise ValueError(f'fused_fourier_unit: {h}x{w} exceeds {MAX_SIDE}')
    wp, bp = planar if planar is not None else planar_params(
        conv_weight, bn_weight, bn_bias, bn_mean, bn_var, eps)
    if wp.device != x.device or tuple(wp.shape) != (2 * c, 2 * co):
        raise ValueError('fused_fourier_unit: planar params do not match x')
    wf = w // 2 + 1
    bufs = dict(_twiddles(h, w, x.device))
    bufs['x'] = x.contiguous(memory_format=torch.channels_last)
    bufs['s0'] = torch.empty(b * h * 2 * wf * max(c, co), dtype=torch.float32,
                             device=x.device)
    bufs['s1'] = torch.empty_like(bufs['s0'])
    bufs['wp'] = wp
    bufs['out'] = torch.empty((b, co, h, w), dtype=torch.float32,
                              device=x.device,
                              memory_format=torch.channels_last)
    fn = _build.load('fourier_unit').lama_fu_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4

    def view(spec):
        name, sb, row, col = spec
        t = bufs[name]
        return _View(t.data_ptr(), int(t.dtype == torch.bfloat16), sb,
                     _Split(*row), _Split(*col))

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for st in _stage_plan(b, h, w, c, co):
            name, sb, row, col = st['out']
            out = _Out(bufs[name].data_ptr(), sb, _Split(*row), _Split(*col),
                       bp.data_ptr() if st.get('bias') else None,
                       int(st.get('relu', False)))
            a, bv = view(st['a']), view(st['b'])
            err = fn(st['M'], st['N'], st['K'], st['batches'],
                     ctypes.addressof(a), ctypes.addressof(bv),
                     ctypes.addressof(out), stream)
            if err != 0:
                raise RuntimeError(f'fused_fourier_unit: CUDA launch failed '
                                   f'with error {err}')
    return bufs['out']


fused_fourier_unit.launches = 0
