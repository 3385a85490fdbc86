"""Image I/O and padding helpers, HWC convention (NHWC batches).

A copy of lama_tpu/data/io.py (reference saicinpainting/evaluation/data.py
:12-55 semantics), so the port imports nothing of lama_tpu:
- load_image: PIL -> float32 [0,1], HWC
- pad_img_to_modulo: numpy *symmetric* padding bottom/right
- scale_image: cv2 resize (area for down, nearest for masks)
"""
import os

import cv2
import numpy as np
import PIL.Image as Image


def load_image(fname, mode='RGB', return_orig=False):
    img = np.array(Image.open(fname).convert(mode))
    if img.ndim == 2:
        img = img[..., None]
    out_img = img.astype('float32') / 255.0
    if return_orig:
        return out_img, img
    return out_img


def save_image(fname, img):
    """float [0,1] (or pre-quantized uint8) HWC RGB -> 8-bit file (any
    cv2-supported extension)."""
    os.makedirs(os.path.dirname(fname), exist_ok=True)
    arr = np.asarray(img)
    if arr.dtype != np.uint8:  # uint8 passes through (serving wire=uint8)
        arr = np.clip(arr * 255.0, 0, 255).astype('uint8')
    if arr.ndim == 3 and arr.shape[-1] == 3:
        arr = cv2.cvtColor(arr, cv2.COLOR_RGB2BGR)
    cv2.imwrite(fname, arr)


def ceil_modulo(x, mod):
    if x % mod == 0:
        return x
    return (x // mod + 1) * mod


def pad_img_to_modulo(img, mod):
    """HWC symmetric pad bottom/right to a multiple of mod."""
    height, width = img.shape[:2]
    out_height = ceil_modulo(height, mod)
    out_width = ceil_modulo(width, mod)
    return np.pad(img, ((0, out_height - height), (0, out_width - width), (0, 0)),
                  mode='symmetric')


def scale_image(img, factor, interpolation=cv2.INTER_AREA):
    """HWC resize by factor; nearest for masks."""
    squeeze = img.ndim == 3 and img.shape[-1] == 1
    src = img[..., 0] if squeeze else img
    out = cv2.resize(src, dsize=None, fx=factor, fy=factor, interpolation=interpolation)
    return out[..., None] if squeeze else out
