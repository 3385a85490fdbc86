"""The int8 conv of int8 serving: CUDA kernel, its plan and its weight
packing (csrc/conv_int8.cu), with ops/quant.py's plain versions.

No TPU kernel stands behind it: lama_tpu's quantized convs are XLA convs
with int32 accumulation (lama_tpu/ops/quant.py:108 and :151). A conv on the
card is three launches, two with a calibrated scale: max |x| over the
whole tensor (dynamic scale), the quantize pass to int8 NHWC codes with
the channels padded to a multiple of CHUNK, and one implicit GEMM on
Hopper's int8 wgmma (m64nNk32, s8 x s8 -> s32, both operands staged in
shared memory) with int32 sums and the dequantize epilogue (see the
source's header). A conv is a list of phases (`conv_plan`,
`conv_transpose_plan`), each a stride-s gather with its own taps: a
Conv2d is one phase of kh * kw taps (d apart when dilated: the
multidilated branches); a stride-2 ConvTranspose2d is four
phases, the output's row and column parities, of 1, 2, 2 and 4 taps over
the undilated input. The weights are quantized per output channel and
packed once per set of weights (`pack_weight`, cached by ops/conv.py's
modules) as (taps, C_out padded to COP_ALIGN, C padded to CHUNK) int8.

The wrappers call two registered ops (library.py): `int8_amax_quantize`
(the amax and quantize passes; with a calibrated scale `int8_quantize`,
the quantize pass alone on the act_amax buffer as it stands) and
`int8_conv` (the GEMM), which launch the
kernels on a CUDA tensor (or raise) and compute the plain versions on a CPU
one (`quantize_activation_plain`, `conv_codes_plain`: ops/quant.py's
arithmetic). kernels='plain', and a CPU call that needs a gradient, take
ops/quant.py's plain conv itself. The GEMM op's CUDA implementation counts
the convs in quantized_conv2d's `.launches`. int8 is for serving only: the
rounding has no gradient, and a CUDA call that needs one raises.
"""
import ctypes
import functools
from collections import namedtuple

import torch

from .. import quant
from . import _build
from ._autograd import needs_grad

# the kernel's constants (csrc/conv_int8.cu; tests/test_torch_int8.py
# checks that the source agrees)
THREADS = 256             # two consumer warpgroups
BM = 256                  # output pixels a block tile
TILE_N = (64, 128, 192)   # the instances' output channels a block tile
CHUNK = 32                # input channels a K chunk (one wgmma k32 step)
KCH = 4                   # chunks a pipeline stage
GROUP = 16                # bytes of K a core-matrix row
STAGES = 4
COP_ALIGN = 128           # the packed weight's C_out padding
MAX_TAPS = 9
MAX_PHASES = 4
BORDERS = {'zeros': 0, 'reflect': 1, 'replicate': 2}
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, 'acc': 2}

# one phase: output offset (oy0, ox0), grid (hg, wg), taps [(dy, dx, wtap)]
Phase = namedtuple('Phase', 'oy0 ox0 hg wg taps')
# a conv's launch plan: its phases, the gather's input stride, the output
# stride, the border, the output's H and W
Plan = namedtuple('Plan', 'phases stride ostride border ho wo')


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def tile_n(co: int) -> int:
    """The instance's BN for C_out output channels: the fewest padded
    columns, ties to the wider tile."""
    return min(TILE_N, key=lambda bn: (round_up(co, bn), -bn))


def _refuse(what, shape):
    return NotImplementedError(
        f'int8 conv kernel: {what} at input {tuple(shape)}: the kernel takes '
        f'ungrouped convs of at most {MAX_TAPS} taps and square strides (no '
        f'int8-eligible layer of lama_tpu\'s models needs more)')


@functools.lru_cache(maxsize=4096)
def conv_plan(x_shape, weight_shape, stride=1, padding=0, dilation=1,
              groups=1, padding_mode='zeros', zero_pad=False) -> Plan:
    """The one phase of a Conv2d on an NCHW input of x_shape: tap (ky, kx)
    reads (ho * s + ky * dh - ph, wo * s + kx * dw - pw) through the border
    (zeros for a zero-padded conv or under zero_pad), weight slice
    ky * kw + kx. A reflect border folds once, so it needs each pad below
    its side; the reads then stay within one fold at any dilation. Raises
    for what the kernel does not take. Cached: a wrapper's check and its
    op's launch read one plan (the arguments are shapes and tuples)."""
    _, c, h, w = x_shape
    kh, kw = weight_shape[-2:]
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    dh, dw = _pair(dilation)
    if groups != 1:
        raise _refuse(f'groups={groups}', x_shape)
    if sh != sw or kh * kw > MAX_TAPS:
        raise _refuse(f'kernel {kh}x{kw}, stride {stride}', x_shape)
    border = 'zeros' if zero_pad or not (ph or pw) else padding_mode
    if border not in BORDERS:
        raise ValueError(f'padding_mode={padding_mode!r}')
    if border == 'reflect' and (ph >= h or pw >= w):
        raise ValueError(f'reflect padding {padding} needs H, W > pad: '
                         f'{tuple(x_shape)}')
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    taps = tuple((ky * dh - ph, kx * dw - pw, ky * kw + kx)
                 for ky in range(kh) for kx in range(kw))
    return Plan((Phase(0, 0, ho, wo, taps),), sh, 1, BORDERS[border], ho, wo)


def _transposed_taps(k, s, p, r):
    """(input offset, tap) of the taps of output residue r: oy = a s + r
    reads iy = a + (r + p - ky) / s where that is whole."""
    return [((r + p - ky) // s, ky) for ky in range(k) if (r + p - ky) % s == 0]


@functools.lru_cache(maxsize=4096)
def conv_transpose_plan(x_shape, weight_shape, stride=2, padding=1,
                        output_padding=1) -> Plan:
    """The phases of a ConvTranspose2d (weight (I, O, kh, kw)): one per
    output residue (py, px) mod the stride, each a stride-1 gather of the
    undilated input with a zero border; k3 s2 p1 op1 gives four phases of
    1, 2, 2 and 4 taps. Cached, as conv_plan."""
    _, c, h, w = x_shape
    kh, kw = weight_shape[-2:]
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    oph, opw = _pair(output_padding)
    if sh != sw or sh * sw > MAX_PHASES:
        raise _refuse(f'transposed stride {stride}', x_shape)
    ho = (h - 1) * sh - 2 * ph + kh + oph
    wo = (w - 1) * sw - 2 * pw + kw + opw
    phases = []
    for py in range(min(sh, ho)):
        for px in range(min(sw, wo)):
            taps = tuple((dy, dx, ky * kw + kx)
                         for dy, ky in _transposed_taps(kh, sh, ph, py)
                         for dx, kx in _transposed_taps(kw, sw, pw, px))
            if len(taps) > MAX_TAPS:
                raise _refuse(f'transposed kernel {kh}x{kw}', x_shape)
            if taps:
                phases.append(Phase(py, px, -(-(ho - py) // sh),
                                    -(-(wo - px) // sw), taps))
    if len(phases) != min(sh, ho) * min(sw, wo):
        # an output residue no tap reaches is all bias: not a shipped layer
        raise _refuse(f'transposed kernel {kh}x{kw} < stride {stride}',
                      x_shape)
    return Plan(tuple(phases), 1, sh, BORDERS['zeros'], ho, wo)


@torch.no_grad()
def pack_weight(weight, transposed: bool = False):
    """(packed codes (taps, C_out padded to COP_ALIGN, C padded to CHUNK)
    int8, scales (C_out,) float32) of a Conv2d weight (O, I, kh, kw) or a
    ConvTranspose2d weight (I, O, kh, kw); tap ky * kw + kx, zeros in the
    padding. The codes and scales are ops/quant.py's."""
    wq, s_w = quant.quantize_weight(weight, transposed)
    taps = wq.permute(2, 3, 1, 0) if transposed else wq.permute(2, 3, 0, 1)
    kh, kw, co, c = taps.shape
    packed = torch.zeros((kh * kw, round_up(co, COP_ALIGN),
                          round_up(c, CHUNK)), dtype=torch.int8,
                         device=weight.device)
    packed[:, :co, :c] = taps.reshape(kh * kw, co, c)
    return packed, s_w.contiguous()


class _Phase(ctypes.Structure):
    _fields_ = [('oy0', ctypes.c_int), ('ox0', ctypes.c_int),
                ('hg', ctypes.c_int), ('wg', ctypes.c_int),
                ('taps', ctypes.c_int), ('dy', ctypes.c_int * MAX_TAPS),
                ('dx', ctypes.c_int * MAX_TAPS),
                ('wtap', ctypes.c_int * MAX_TAPS)]


class _Args(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in
                 ('x', 'w', 'amax', 's_w', 'bias', 'out')]
                + [(k, ctypes.c_int) for k in
                   ('out_kind', 'B', 'H', 'W', 'Cp', 'Ho', 'Wo', 'Co', 'COp',
                    'stride', 'ostride', 'border', 'n_phases')]
                + [('phase', _Phase * MAX_PHASES)])


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load('conv_int8')
    lib.lama_int8_amax.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.lama_int8_quantize.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    lib.lama_int8_conv.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
    for fn in (lib.lama_int8_amax, lib.lama_int8_quantize,
               lib.lama_int8_conv):
        fn.restype = ctypes.c_int
    return lib


def _check(what, err):
    if err != 0:
        raise RuntimeError(f'int8 conv: CUDA launch of {what} failed with '
                           f'error {err}')


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def activation_amax(x):
    """max |x| of x (B, C, H, W) bf16 or fp32 on the card, (1,) float32 on
    the card: the amax kernel (the dynamic scale)."""
    _check_input(x)
    dense = x if (x.is_contiguous() or x.is_contiguous(
        memory_format=torch.channels_last)) else x.contiguous()
    amax = torch.empty(1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _check('the amax pass', _lib().lama_int8_amax(
            dense.data_ptr(), int(x.dtype == torch.bfloat16), dense.numel(),
            amax.data_ptr(), _stream(x)))
    return amax


def quantize_codes(x, amax):
    """x (B, C, H, W) bf16 or fp32 on the card -> its codes (B, H, W, Cp)
    int8 at the scale amax / QMAX: the quantize kernel. `amax` is one
    float32 on x's device (activation_amax's, or a calibrated act_amax as
    it stands)."""
    _check_input(x)
    if (amax.dtype != torch.float32 or amax.numel() != 1
            or amax.device != x.device):
        raise ValueError(f'int8 conv: amax {amax.dtype} {tuple(amax.shape)} '
                         f'on {amax.device} for an input on {x.device}')
    b, c, h, w = x.shape
    cp = round_up(c, CHUNK)
    xq = torch.empty((b, h, w, cp), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        _check('the quantize pass', _lib().lama_int8_quantize(
            x.data_ptr(), int(x.dtype == torch.bfloat16), b, c, h, w,
            *x.stride(), cp, amax.data_ptr(), xq.data_ptr(), _stream(x)))
    return xq


def _check_input(x):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'int8 conv: input dtype {x.dtype}')


def static_amax(act_amax, device):
    """A calibrated act_amax as the quantize and GEMM launches read it: one
    float32 on `device`; the buffer itself when it is one already."""
    if act_amax.dtype == torch.float32 and act_amax.device == device:
        return act_amax
    return act_amax.to(device=device, dtype=torch.float32)


def quantize_activation(x, act_amax=None):
    """x (B, C, H, W) bf16 or fp32 on the card -> (codes (B, H, W, Cp) int8,
    amax, one float32 on the card): the amax kernel unless the calibrated
    `act_amax` is given (then returned as `static_amax` gives it), then
    the quantize kernel."""
    amax = (activation_amax(x) if act_amax is None
            else static_amax(act_amax, x.device))
    return quantize_codes(x, amax), amax


def conv_codes(xq, amax, packed, s_w, bias, plan: Plan, co: int,
               out_dtype=torch.bfloat16):
    """The GEMM launch on quantize_activation's codes: (B, co, Ho, Wo),
    channels-last, in out_dtype, or the int32 sums with out_dtype='acc'."""
    b, h, w, cp = xq.shape
    if packed.shape[2] != cp or packed.dtype != torch.int8:
        raise ValueError(f'int8 conv: packed weight {tuple(packed.shape)} for '
                         f'codes {tuple(xq.shape)}')
    out = torch.empty((b, co, plan.ho, plan.wo),
                      dtype=torch.int32 if out_dtype == 'acc' else out_dtype,
                      device=xq.device, memory_format=torch.channels_last)
    if bias is not None:
        bias = bias.detach().float().contiguous()
    args = conv_args(xq, amax, packed, s_w, bias, plan, out)
    with torch.cuda.device(xq.device):
        _check('the conv', _lib().lama_int8_conv(
            ctypes.addressof(args), tile_n(co), _stream(xq)))
    return out


def conv_args(xq, amax, packed, s_w, bias, plan: Plan, out):
    """lama_int8_conv's argument structure for these buffers: codes (B, H,
    W, Cp), amax (1,), the packed weight and its scales, a float32 bias or
    None, and the channels-last output (B, C_out, Ho, Wo) whose dtype names
    the epilogue (int32: the raw sums)."""
    b, h, w, cp = xq.shape
    kind = OUT_KINDS['acc' if out.dtype == torch.int32 else out.dtype]
    args = _Args(x=xq.data_ptr(), w=packed.data_ptr(), amax=amax.data_ptr(),
                 s_w=s_w.data_ptr(),
                 bias=None if bias is None else bias.data_ptr(),
                 out=out.data_ptr(), out_kind=kind, B=b, H=h, W=w, Cp=cp,
                 Ho=plan.ho, Wo=plan.wo, Co=out.shape[1], COp=packed.shape[1],
                 stride=plan.stride, ostride=plan.ostride, border=plan.border,
                 n_phases=len(plan.phases))
    for i, ph in enumerate(plan.phases):
        slot = args.phase[i]
        slot.oy0, slot.ox0, slot.hg, slot.wg = ph.oy0, ph.ox0, ph.hg, ph.wg
        slot.taps = len(ph.taps)
        for t, (dy, dx, wt) in enumerate(ph.taps):
            slot.dy[t], slot.dx[t], slot.wtap[t] = dy, dx, wt
    return args


def quantize_activation_plain(x, act_amax=None):
    """Plain version of quantize_activation: (codes (B, H, W, Cp) int8, the
    channels zero-filled to a multiple of CHUNK, amax (1,) float32), the
    codes ops/quant.py's."""
    amax = (x.detach().float().abs().amax() if act_amax is None
            else act_amax.detach().float()).reshape(1).clone()
    q = quant.quantize(x, torch.clamp(amax, min=1e-12) / quant.QMAX)
    b, c, h, w = x.shape
    codes = q.new_zeros((b, h, w, round_up(c, CHUNK)))
    codes[..., :c] = q.permute(0, 2, 3, 1)
    return codes, amax


def unpack_weight(packed, c: int, co: int, kh: int, kw: int,
                  transposed: bool = False):
    """pack_weight's codes back in the weight's layout: (C_out, C, kh, kw),
    or (C, C_out, kh, kw) for a ConvTranspose2d."""
    taps = packed[:, :co, :c].reshape(kh, kw, co, c)
    return taps.permute(3, 2, 0, 1) if transposed else taps.permute(2, 3, 0, 1)


def conv_codes_plain(xq, amax, packed, s_w, bias, c, co, kh, kw, stride,
                     padding, dilation, output_padding, padding_mode,
                     zero_pad, transposed, out_dtype):
    """Plain version of the GEMM launch on quantize_activation's codes
    (ops/quant.py's exact int32 sums and dequantize): (B, co, Ho, Wo) in
    out_dtype, channels-last."""
    xc = xq[..., :c].permute(0, 3, 1, 2)
    wq = unpack_weight(packed, c, co, kh, kw, transposed)
    if transposed:
        acc = quant.conv_transpose2d_acc(xc, wq, stride, padding,
                                         output_padding)
    else:
        acc = quant.conv2d_acc(xc, wq, stride, padding, dilation, 1,
                               padding_mode, zero_pad)
    s_x = torch.clamp(amax.reshape(()), min=1e-12) / quant.QMAX
    out = quant.dequantize(acc, s_x, s_w, bias, out_dtype)
    return out.contiguous(memory_format=torch.channels_last)


def _on_kernel(x, kernels, params):
    """Whether the registered ops run (the kernel on a CUDA tensor, the
    plain version on a CPU one): not under kernels='plain', nor on the CPU
    when a gradient is needed (the plain version then runs itself); on the
    card a call that needs a gradient raises."""
    if kernels == 'plain':
        return False
    if needs_grad(x, *params):
        if not x.is_cuda:
            return False
        raise RuntimeError('int8 conv: int8 convs serve only (the rounding '
                           'has no gradient); run under torch.no_grad or '
                           'inference_mode')
    return True


def _takes(x, plan, *args) -> bool:
    """Whether the kernel takes the conv: `plan(*args)` raises
    NotImplementedError for what it refuses, which a CUDA call passes on
    and a CPU call answers with the plain version."""
    if x.is_cuda:
        plan(*args)
        return True
    try:
        plan(*args)
    except NotImplementedError:
        return False
    return True


def _conv_op(x, act_amax, wp, s_w, bias, co, kh, kw, stride=1, padding=0,
             dilation=1, output_padding=0, padding_mode='zeros',
             zero_pad=False, transposed=False):
    """The two registered ops of an int8 conv: the quantize pass (with the
    amax pass unless `act_amax` is given: then both ops read the buffer as
    it stands), then the GEMM."""
    if act_amax is None:
        xq, amax = torch.ops.lama_tpu_torch.int8_amax_quantize.default(x)
    else:
        amax = static_amax(act_amax, x.device)
        xq = torch.ops.lama_tpu_torch.int8_quantize.default(x, amax)
    return torch.ops.lama_tpu_torch.int8_conv.default(
        xq, amax, wp, s_w, bias, x.shape[1], co, kh, kw, _pair(stride),
        _pair(padding), _pair(dilation), _pair(output_padding), padding_mode,
        bool(zero_pad), transposed, x.dtype)


def quantized_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                     groups=1, padding_mode='zeros', act_amax=None,
                     zero_pad: bool = False, packed=None, kernels='cuda'):
    """int8 Conv2d, NCHW input (any memory format), OIHW weight; returns
    x's dtype (channels-last from the registered ops). `packed`:
    pack_weight's result, when the caller keeps it."""
    if not (_on_kernel(x, kernels, (weight, bias)) and _takes(
            x, conv_plan, x.shape, weight.shape, stride, padding, dilation,
            groups, padding_mode, zero_pad)):
        return quant.quantized_conv2d(x, weight, bias, stride, padding,
                                      dilation, groups, padding_mode,
                                      act_amax=act_amax, zero_pad=zero_pad)
    wp, s_w = packed if packed is not None else pack_weight(weight)
    return _conv_op(x, act_amax, wp, s_w, bias, weight.shape[0],
                    *weight.shape[-2:], stride, padding, dilation, 0,
                    padding_mode, zero_pad)


def quantized_conv_transpose2d(x, weight, bias=None, stride=2, padding=1,
                               output_padding=1, act_amax=None, packed=None,
                               kernels='cuda'):
    """int8 ConvTranspose2d, NCHW input, weight (I, O, kh, kw); returns
    x's dtype. Counted with quantized_conv2d: one kernel."""
    if not (_on_kernel(x, kernels, (weight, bias)) and _takes(
            x, conv_transpose_plan, x.shape, weight.shape, stride, padding,
            output_padding)):
        return quant.quantized_conv_transpose2d(
            x, weight, bias, stride, padding, output_padding,
            act_amax=act_amax)
    wp, s_w = (packed if packed is not None
               else pack_weight(weight, transposed=True))
    return _conv_op(x, act_amax, wp, s_w, bias, weight.shape[1],
                    *weight.shape[-2:], stride, padding, 1, output_padding,
                    transposed=True)


quantized_conv2d.launches = 0
