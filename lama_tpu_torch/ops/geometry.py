"""Geometric warps (rotation, affine) by bilinear sampling, NCHW
(counterpart of lama_tpu/ops/geometry.py, which replaces the reference's
kornia).

The sampling is lama_tpu's own gather (geometry.py:10-40): bilinear
weights from floor(coordinate), taps outside the image either zero or
reflected into it by `reflect_index` (period 2n - 2, the edge pixel not
repeated). `F.grid_sample` is not used: its `align_corners` and reflection
conventions are kornia's, not this gather's.

Random warps come in two parts, so that a test can feed the port the JAX
package's `jax.random` draws: `draw_random_affine` takes the angles and
shifts from a `torch.Generator`, `random_affine` warps by given ones.
"""
import torch


def reflect_index(i, n: int):
    """Reflect float indices into [0, n - 1] (geometry.py:10-16)."""
    period = max(2 * n - 2, 1)
    i = torch.remainder(i.abs(), period)
    return torch.where(i >= n, period - i, i)


def _grid_sample_bilinear(x, ys, xs, padding_mode='zeros'):
    """Sample NCHW `x` at float coordinates (ys, xs), each (B, H', W') or
    (H', W'); padding_mode 'zeros' (taps outside -> 0) or 'reflection'."""
    b, c, h, w = x.shape
    if ys.dim() == 2:
        ys, xs = ys.expand(b, *ys.shape), xs.expand(b, *xs.shape)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[:, None], (xs - x0)[:, None]
    flat = x.reshape(b, c, h * w)

    def gather(yi, xi):
        if padding_mode == 'reflection':
            yc, xc = reflect_index(yi, h).long(), reflect_index(xi, w).long()
            valid = None
        else:
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            yc, xc = yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(b, 1, -1).expand(b, c, -1)
        vals = torch.gather(flat, 2, idx).reshape(b, c, *yi.shape[1:])
        return vals if valid is None else vals * valid[:, None].to(vals.dtype)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _pixel_grid(h, w, device, dtype=torch.float32):
    return torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device),
                          indexing='ij')


def rotate(x, angle_degrees):
    """Rotate NCHW `x` by `angle_degrees` (counter-clockwise in image
    coordinates, kornia's convention) around the centre, bilinear, zero
    outside (geometry.py:43-56). The angle is a float or a 0-dim or
    one-element tensor; the warp is differentiable in a tensor angle (the
    learnable spatial transform's), and reads it on the device without a
    host sync. The coordinates are float32, float64 for a float64 angle
    (as jnp promotes them under x64)."""
    _, _, h, w = x.shape
    if not torch.is_tensor(angle_degrees):
        angle_degrees = torch.tensor(float(angle_degrees))
    dtype = torch.promote_types(angle_degrees.dtype, torch.float32)
    theta = torch.deg2rad(angle_degrees.to(x.device, dtype).reshape(()))
    cos, sin = torch.cos(theta), torch.sin(theta)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = _pixel_grid(h, w, x.device, dtype)
    xs = cos * (xx - cx) - sin * (yy - cy) + cx
    ys = sin * (xx - cx) + cos * (yy - cy) + cy
    return _grid_sample_bilinear(x, ys, xs)


def affine_warp(x, matrix, padding_mode='zeros'):
    """Warp NCHW `x` by inverse 2x3 affine `matrix` (output -> input
    pixel coordinates), (2, 3) for the batch or (B, 2, 3) per sample
    (geometry.py:59-66)."""
    _, _, h, w = x.shape
    yy, xx = _pixel_grid(h, w, x.device)
    m = torch.as_tensor(matrix, dtype=torch.float32, device=x.device)
    if m.dim() == 2:
        m = m[None]
    m = m[:, :, :, None, None]
    xs = m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2]
    ys = m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2]
    return _grid_sample_bilinear(x, ys, xs, padding_mode=padding_mode)


def draw_random_affine(gen: torch.Generator, b: int, h: int, w: int,
                       degrees=30.0, translate=0.2):
    """The random part of `random_affine` (geometry.py:69-80): per sample,
    an angle uniform in +-degrees and shifts uniform in +-translate times
    the width (x) and the height (y); float32 CPU tensors (B,), in degrees
    and pixels."""
    def uniform(lo, hi):
        return torch.rand(b, generator=gen) * (hi - lo) + lo

    angles = uniform(-degrees, degrees)
    tx = uniform(-translate, translate) * w
    ty = uniform(-translate, translate) * h
    return angles, tx, ty


def random_affine(x, angles, tx, ty, padding_mode='reflection'):
    """Rotate each sample of NCHW `x` by `angles` (degrees) around the
    centre and shift it by (tx, ty) pixels, the kornia RandomAffine
    equivalent the fake fakes use (geometry.py:69-93); the draws come from
    `draw_random_affine` or a test."""
    _, _, h, w = x.shape
    rad = torch.deg2rad(torch.as_tensor(angles, dtype=torch.float32))
    cos, sin = torch.cos(rad), torch.sin(rad)
    tx = torch.as_tensor(tx, dtype=torch.float32)
    ty = torch.as_tensor(ty, dtype=torch.float32)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    m = torch.stack([torch.stack([cos, -sin, cx - cos * cx + sin * cy - tx], -1),
                     torch.stack([sin, cos, cy - sin * cx - cos * cy - ty], -1)],
                    1)
    return affine_warp(x, m.to(x.device), padding_mode=padding_mode)
