"""int8 convolutions: which convs quantize, and the plain versions of the
quantized Conv2d and ConvTranspose2d (counterpart of lama_tpu/ops/quant.py:
conv_eligible :54, quantized_conv2d :74, quantized_conv_transpose2d :123).

The numerics are lama_tpu's:
- one scale per output channel for the weight, max(|w|, 1e-12) / 127;
- one scale for the whole activation tensor, max(amax, 1e-12) / 127 in
  float32, with amax the tensor's max |x| (dynamic) or a calibrated value
  (static; serving.py::calibrate_int8);
- codes clamp(round(t / s), -127, 127): a division, not a product with the
  reciprocal, and round half to even (torch.round and jnp.round agree);
- an int32 sum of the products, then float(acc) * (s_x * s_w[co]) +
  bias[co] in float32, then the cast to the compute dtype.
`zero_pad` treats a reflect or replicate border as zeros inside these convs
only (quant.py:99-106).

The plain versions sum exactly: F.conv2d / F.conv_transpose2d in float64 on
the codes (|acc| <= 127^2 * 9 * 512 < 2^53), rounded to int32. They run the
same on the CPU and on the card, so the card's check holds the int8
kernel's int32 sums bit-equal to theirs (ops/kernels/conv_int8.py).
"""
import torch
import torch.nn.functional as F

from .pad import pad2d
from .serving_mode import DEFAULT as _DEFAULT_MODE, ServingMode

QMAX = 127


def conv_eligible(in_features: int, out_features: int, groups: int,
                  kh: int, kw: int, mode: ServingMode = _DEFAULT_MODE) -> bool:
    """Whether a conv quantizes: its per-group contraction depth and output
    width reach the mode's gates (the stem's 4 input channels and the
    head's 3 outputs stay in the compute dtype)."""
    g = max(groups, 1)
    return (in_features // g >= mode.min_contraction_channels
            and out_features // g >= mode.min_out_channels)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def weight_scales(weight, out_dim: int = 0):
    """Per-output-channel scales (C_out,), float32: max |w| over every
    other dim. out_dim 0 for a Conv2d weight (O, I, kh, kw), 1 for a
    ConvTranspose2d weight (I, O, kh, kw)."""
    dims = [d for d in range(weight.dim()) if d != out_dim]
    amax = weight.float().abs().amax(dim=dims)
    return torch.clamp(amax, min=1e-12) / QMAX


def act_scale(x, act_amax=None):
    """The activation scale, a float32 0-dim tensor: from the calibrated
    `act_amax` when given, else from max |x| of the whole batch tensor."""
    amax = x.float().abs().amax() if act_amax is None else act_amax
    return torch.clamp(torch.as_tensor(amax, dtype=torch.float32,
                                       device=x.device), min=1e-12) / QMAX


def quantize(t, scale):
    """int8 codes clamp(round(t / scale), -127, 127); `scale` broadcasts."""
    return torch.clamp(torch.round(t.float() / scale), -QMAX, QMAX).to(
        torch.int8)


def quantize_weight(weight, transposed: bool = False):
    """(codes int8 in the weight's layout, scales (C_out,) float32)."""
    out_dim = 1 if transposed else 0
    s_w = weight_scales(weight, out_dim)
    shape = [1] * weight.dim()
    shape[out_dim] = -1
    return quantize(weight, s_w.view(shape)), s_w


def conv2d_acc(xq, wq, stride=1, padding=0, dilation=1, groups=1,
               padding_mode='zeros', zero_pad: bool = False):
    """int32 sums of an int8 conv, exactly: a reflect or replicate border
    is gathered on the codes (zeros with zero_pad), zeros stay in the
    conv."""
    padding = _pair(padding)
    x = xq.double()
    if padding_mode != 'zeros' and any(padding) and not zero_pad:
        x = pad2d(x, padding, mode=padding_mode)
        padding = (0, 0)
    acc = F.conv2d(x, wq.double(), None, stride, padding, dilation, groups)
    return torch.round(acc).to(torch.int32)


def conv_transpose2d_acc(xq, wq, stride=2, padding=1, output_padding=1):
    """int32 sums of an int8 transposed conv (weight (I, O, kh, kw)),
    exactly."""
    acc = F.conv_transpose2d(xq.double(), wq.double(), None, stride, padding,
                             output_padding)
    return torch.round(acc).to(torch.int32)


def dequantize(acc, s_x, s_w, bias, out_dtype):
    """float(acc) * (s_x * s_w[co]) + bias[co] in float32, then out_dtype;
    acc (B, C_out, H, W)."""
    out = acc.float() * (s_x * s_w).view(1, -1, 1, 1)
    if bias is not None:
        out = out + bias.float().view(1, -1, 1, 1)
    return out.to(out_dtype)


def quantized_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                     groups=1, padding_mode='zeros', out_dtype=None,
                     act_amax=None, zero_pad: bool = False):
    """Plain int8 Conv2d, NCHW input, OIHW weight; returns out_dtype (x's
    dtype by default)."""
    wq, s_w = quantize_weight(weight)
    s_x = act_scale(x, act_amax)
    acc = conv2d_acc(quantize(x, s_x), wq, stride, padding, dilation, groups,
                     padding_mode, zero_pad)
    return dequantize(acc, s_x, s_w, bias, out_dtype or x.dtype)


def quantized_conv_transpose2d(x, weight, bias=None, stride=2, padding=1,
                               output_padding=1, out_dtype=None,
                               act_amax=None):
    """Plain int8 ConvTranspose2d, NCHW input, weight (I, O, kh, kw)."""
    wq, s_w = quantize_weight(weight, transposed=True)
    s_x = act_scale(x, act_amax)
    acc = conv_transpose2d_acc(quantize(x, s_x), wq, stride, padding,
                               output_padding)
    return dequantize(acc, s_x, s_w, bias, out_dtype or x.dtype)
