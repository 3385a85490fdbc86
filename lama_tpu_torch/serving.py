"""Serving helpers: model-dir loading, int8 calibration and the inpainting
forward (counterpart of lama_tpu/serving.py)."""
import os
from typing import Tuple

import torch

from .config import load_yaml, resolve_interpolations, to_dict
from .convert import load_checkpoint
from .data.io import ceil_modulo
from .models import make_generator
from .ops.serving_mode import ServingMode

# int8 computes in bf16, with the eligible convs in int8 (lama_tpu/
# serving.py:55-59)
_DTYPES = {'fp32': torch.float32, 'bf16': torch.bfloat16,
           'int8': torch.bfloat16}


def generator_config(path: str) -> dict:
    """The `generator:` section of a training config (a model dir's
    config.yaml, or configs/training/*.yaml), interpolations resolved, as
    plain Python values; `kind` names the generator."""
    config = load_yaml(path)
    resolve_interpolations(config)
    return to_dict(config.generator)


def load_serving_model(model_path: str, checkpoint: str = 'best.ckpt',
                       precision: str = 'bf16', device='cuda',
                       quant_zero_pad: bool = False,
                       spectral_bf16_store: bool = False,
                       s2d_out_head: bool = False,
                       xfold_stem: bool = False) -> Tuple[torch.nn.Module, dict]:
    """Build the generator from <model_path>/config.yaml, load
    <model_path>/models/<checkpoint> (a reference-format .ckpt/.pth/.pt)
    with strict key matching, and return (generator in eval mode on
    `device`, generator kwargs). precision: fp32 | bf16 | int8. fp32 turns
    TF32 off for matmuls and cuDNN convs, which PyTorch allows in cuDNN by
    default. int8 computes in bf16 with the eligible convs in int8
    (ops/kernels/conv_int8.py), with dynamic activation scales until
    `calibrate_int8` records static ones. The serving options, as in
    lama_tpu (serving.py:21-90), become the generator's ServingMode:
    quant_zero_pad (int8 only): zero borders inside the quantized convs;
    spectral_bf16_store (bf16 or int8): the FourierUnit's DFT stages
    stored in bf16; s2d_out_head and xfold_stem: lama_tpu's exact
    rewrites of the head and the stem, which the port's head and stem
    kernels already compute on the card, so they change no output."""
    if precision not in _DTYPES:
        raise ValueError(f'precision={precision!r}: expected fp32, bf16 or '
                         'int8')
    if quant_zero_pad and precision != 'int8':
        raise ValueError('quant_zero_pad requires precision=int8 (it only '
                         'affects the quantized convs)')
    if spectral_bf16_store and precision == 'fp32':
        raise ValueError('spectral_bf16_store has no effect under '
                         'precision=fp32 (the spectral operands are fp32); '
                         'use bf16 or int8')
    mode = ServingMode(int8=precision == 'int8', zero_pad=bool(quant_zero_pad),
                       spectral_bf16_store=bool(spectral_bf16_store),
                       s2d='out_head' if s2d_out_head else 'off',
                       xfold_stem=bool(xfold_stem))
    if precision == 'fp32':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    gen_kwargs = generator_config(os.path.join(model_path, 'config.yaml'))
    kind = gen_kwargs.pop('kind')
    generator = make_generator(kind, serving_mode=mode,
                               dtype=_DTYPES[precision], **gen_kwargs)
    ckpt = os.path.join(model_path, 'models', str(checkpoint))
    if not ckpt.endswith(('.ckpt', '.pth', '.pt')) or not os.path.isfile(ckpt):
        raise FileNotFoundError(f'{ckpt}: expected a reference-format '
                                '.ckpt/.pth/.pt file (orbax directories need '
                                'bin/export_torch_checkpoint.py first)')
    generator.load_state_dict(load_checkpoint(ckpt), strict=True)
    return generator.to(device).eval(), gen_kwargs


def calibrate_int8(generator, batches) -> None:
    """Record each int8 conv's static activation scale (lama_tpu/
    serving.py:93-155): the serving forward (the masked image and the mask
    concatenated, the input each conv sees when serving) over `batches`,
    (image (B, H, W, 3), mask (B, H, W, 1)) float32 pairs, with the mode's
    calibrating flag on, under torch.inference_mode. Each eligible conv's
    `act_amax` buffer ends as the max of its input's max |x| over the
    batches; serving then uses that scale instead of a reduction per call
    (on the calibration batch, the same outputs). Nothing is returned: the
    amax stays in the modules. Raises without int8 and without batches."""
    mode = getattr(generator, 'mode', None)
    if mode is None or not mode.int8:
        raise ValueError('calibrate_int8 requires precision=int8 (the '
                         'generator was not built with '
                         'ServingMode(int8=True))')
    batches = list(batches)
    if not batches:
        raise ValueError('calibrate_int8: no calibration batches given')
    device = next(generator.parameters()).device
    moded = [m for m in generator.modules()
             if isinstance(getattr(m, 'mode', None), ServingMode)]
    for m in moded:
        if getattr(m, 'quantized', False):
            m.act_amax = None
    try:
        for m in moded:
            m.mode = m.mode.but(calibrating=True)
        with torch.inference_mode():
            for image, mask in batches:
                image = torch.as_tensor(image, dtype=torch.float32,
                                        device=device)
                mask = torch.as_tensor(mask, dtype=torch.float32,
                                       device=device)
                generator(torch.cat([image * (1 - mask), mask],
                                    dim=-1).permute(0, 3, 1, 2))
    finally:
        for m in moded:
            m.mode = m.mode.but(calibrating=False)


def bucket_shape(h: int, w: int, modulo: int, bucket: int) -> Tuple[int, int]:
    """The padded (H, W) an original (h, w) input is served at: dataset
    modulo-pad, then bucket-pad (at least one modulo). A copy of
    lama_tpu/serving.py:158-177 without the spatial-shard rounding."""
    def ceil_to(x, mod):
        return ((x + mod - 1) // mod) * mod

    modulo = int(modulo or 0)
    ph = ceil_modulo(int(h), modulo) if modulo else int(h)
    pw = ceil_modulo(int(w), modulo) if modulo else int(w)
    return ceil_to(max(ph, modulo), bucket), ceil_to(max(pw, modulo), bucket)


class Inpainter(torch.nn.Module):
    """The served function as a module, with the semantics of
    lama_tpu/serving.py:180-224: (image (B,H,W,3), mask (B,H,W,1)) float32
    in [0, 1] on the generator's device -> float32 (B,H,W,3), the
    generator's output on (masked image, mask) composited over the known
    pixels (out_key 'inpainted': mask * pred + (1 - mask) * image) or as
    it stands (out_key 'predicted_image'). make_inpaint_forward serves it;
    export.py exports it."""

    def __init__(self, generator, out_key: str = 'inpainted'):
        super().__init__()
        if out_key not in ('inpainted', 'predicted_image'):
            raise ValueError(f'out_key={out_key!r}: expected inpainted or '
                             'predicted_image')
        self.generator = generator
        self.out_key = out_key

    def forward(self, image, mask):
        x = torch.cat([image * (1 - mask), mask], dim=-1).permute(0, 3, 1, 2)
        pred = self.generator(x).permute(0, 2, 3, 1).float()
        if self.out_key == 'predicted_image':
            return pred
        return mask * pred + (1 - mask) * image


def make_inpaint_forward(generator, wire: str = 'fp32',
                         out_key: str = 'inpainted'):
    """The serving forward: `Inpainter(generator, out_key)` under
    torch.inference_mode, on tensors on the generator's device.

    wire: 'fp32' (float32 in [0,1] in, float32 out) or 'uint8' (uint8 image
    0-255 and {0,1} mask in; uint8 out as floor(clip(out * 255, 0, 255)),
    the map save_image applies to float results, so both wires write the
    same files for 8-bit sources)."""
    if wire not in ('fp32', 'uint8'):
        raise ValueError(f'wire={wire!r}: expected fp32 or uint8')
    inpainter = Inpainter(generator, out_key)
    u8 = wire == 'uint8'

    @torch.inference_mode()
    def predict(image, mask):
        if u8:
            image = image.float() / 255.0
            mask = mask.float()
        out = inpainter(image, mask)
        if u8:
            return torch.floor(torch.clamp(out * 255.0, 0.0, 255.0)).to(
                torch.uint8)
        return out
    return predict
