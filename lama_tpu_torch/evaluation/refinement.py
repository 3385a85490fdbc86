"""Multiscale feature refinement for high-resolution inpainting: the
counterpart of lama_tpu/evaluation/refinement.py (reference
evaluation/refinement.py, the Geomagical refiner).

Same semantics:
- a gaussian image/mask pyramid (at most max_scales, px_budget cap,
  min_side floor);
- per scale: the generator's front features z of the masked input are the
  variables; Adam(lr) makes n_iters - 1 updates on a multiscale L1 (known
  region vs the input, plus the hole region of the downscaled prediction vs
  the previous scale's result under an ellipse-eroded mask), then one final
  rear forward;
- the composite mask * pred + (1 - mask) * image.

`refine_predict` takes and returns NHWC, as the JAX function does; inside,
tensors are NCHW. The front runs under torch.no_grad(); the rear runs with
autograd, through the kernels' autograd wrappers on the card (forward: the
kernel, backward: the plain version's VJP). The generator's parameters are
frozen for the call, so only z gets gradients, as `jax.grad` over z does.
The device is the generator's; there is no CPU fallback.
"""
import logging
import math

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from ..models.ffc import FFCResNetGenerator
from ..ops.blur import gaussian_blur2d
from ..ops.resize import interpolate

LOGGER = logging.getLogger(__name__)


def _ceil_modulo(x, mod):
    return x if x % mod == 0 else (x // mod + 1) * mod


def pad_tensor_to_modulo(img, mod):
    """NCHW reflect pad bottom/right to a multiple of mod (reference
    evaluation/data.py:36-40)."""
    h, w = img.shape[2:]
    return F.pad(img, (0, _ceil_modulo(w, mod) - w, 0, _ceil_modulo(h, mod) - h),
                 mode='reflect')


def _pyrdown(im, downsize=None):
    """gaussian 5x5 sigma 1 blur + bilinear half (refinement.py:20-27)."""
    if downsize is None:
        downsize = (im.shape[2] // 2, im.shape[3] // 2)
    im = gaussian_blur2d(im, 5, 1.0)
    return interpolate(im, size=downsize, mode='bilinear', align_corners=False)


def _pyrdown_mask(mask, downsize=None, eps=1e-8, blur_mask=True,
                  round_up=True):
    if downsize is None:
        downsize = (mask.shape[2] // 2, mask.shape[3] // 2)
    if blur_mask:
        mask = gaussian_blur2d(mask, 5, 1.0)
    mask = interpolate(mask, size=downsize, mode='bilinear',
                       align_corners=False)
    if round_up:
        return (mask >= eps).to(mask.dtype)
    return (mask >= 1.0 - eps).to(mask.dtype)


def _ellipse_kernel(size=15):
    return cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                     (size, size)).astype(np.float32)


def _erode_mask(mask, ekernel):
    """Binary erosion of an (N, 1, H, W) mask with a flat structuring
    element, as conv + threshold (kornia erosion + binarise,
    refinement.py:67-73)."""
    kern = torch.from_numpy(ekernel).to(mask.device, mask.dtype)[None, None]
    hits = F.conv2d(mask, kern, padding=ekernel.shape[0] // 2)
    return (hits >= kern.sum() - 1e-3).to(mask.dtype)


def _scale_loss(pred, image, mask3, ref, orig_shape, ekernel):
    """Multiscale L1 (refinement.py:76-84,158-163): known-region L1 on the
    full-resolution prediction + hole-region L1 between the downscaled
    prediction and the previous scale's result. NCHW."""
    known = (mask3 < 1e-8).to(pred.dtype)
    loss = ((pred - image).abs() * known).sum() / known.sum().clamp(min=1e-8)
    pred_crop = pred[:, :, :orig_shape[0], :orig_shape[1]]
    mask_crop = mask3[:, :1, :orig_shape[0], :orig_shape[1]]
    pred_down = _pyrdown(pred_crop)
    mask_down = _pyrdown_mask(mask_crop, blur_mask=False, round_up=False)
    mask_down = _erode_mask(mask_down, ekernel)
    hole = (mask_down >= 1e-8).to(pred.dtype).expand_as(pred_down)
    return loss + (((pred_down - ref).abs() * hole).sum()
                   / hole.sum().clamp(min=1e-8))


def _refine_scale(generator, image, mask, ref_lower_res, orig_shape, n_iters,
                  lr, ekernel):
    """One pyramid scale (refinement.py:101-133), NCHW. Returns the
    composite and the loss of each Adam step (a 1-D float32 tensor; empty
    at the first scale, which has no reference)."""
    masked_image = torch.cat([image * (1 - mask), mask], dim=1)
    with torch.no_grad():
        z = generator(masked_image, stage='front')
    mask3 = mask.expand(-1, 3, -1, -1)

    def rear(z):
        return generator(tuple(z), stage='rear').float()

    steps = []
    if ref_lower_res is not None:
        z = [None if t is None else t.detach().requires_grad_() for t in z]
        ref = ref_lower_res.detach()
        opt = torch.optim.Adam([t for t in z if t is not None], lr=lr,
                               betas=(0.9, 0.999), eps=1e-8)
        for _ in range(n_iters - 1):
            opt.zero_grad(set_to_none=True)
            loss = _scale_loss(rear(z), image, mask3, ref, orig_shape,
                               ekernel)
            loss.backward()
            opt.step()
            steps.append(loss.detach())
    with torch.no_grad():
        pred = rear(z)
    losses = (torch.stack(steps).float().cpu() if steps
              else torch.zeros(0))
    return mask3 * pred + (1 - mask3) * image, losses


def _get_image_mask_pyramid(image, mask, unpad_to_size, min_side, max_scales,
                            px_budget):
    """refinement.py:176-226. image (1, 3, H, W), mask (1, 1, H, W)."""
    if image.shape[0] != 1:
        raise ValueError('the refiner works on batches of size 1')
    h, w = unpad_to_size if unpad_to_size is not None else image.shape[2:]
    h, w = int(h), int(w)
    image = image[:, :, :h, :w]
    mask = mask[:, :, :h, :w]
    if h * w > px_budget:
        ratio = math.sqrt(px_budget / float(h * w))
        h_orig, w_orig = h, w
        h, w = int(h * ratio), int(w * ratio)
        LOGGER.info(f'Image too large for refinement: resizing '
                    f'{(h_orig, w_orig)} to {(h, w)}')
        image = interpolate(image, size=(h, w), mode='bilinear',
                            align_corners=False)
        mask = interpolate(mask, size=(h, w), mode='bilinear',
                           align_corners=False)
        mask = (mask > 1e-8).to(mask.dtype)
    breadth = min(h, w)
    n_scales = min(1 + int(round(max(0, math.log2(breadth / min_side)))),
                   max_scales)
    images, masks = [image], [mask]
    for _ in range(n_scales - 1):
        images.append(_pyrdown(images[-1]))
        masks.append(_pyrdown_mask(masks[-1]))
    return images[::-1], masks[::-1]


def check_refinable(generator):
    """The refiner optimises the features between the generator's front and
    rear stages (the JAX refiner calls `stage='front'`,
    lama_tpu/evaluation/refinement.py:106); only the FFC generator has
    them. Raises ValueError for any other generator."""
    if not isinstance(generator, FFCResNetGenerator):
        raise ValueError(
            f'refine=true needs a generator with front and rear stages '
            f'(ffc_resnet); {type(generator).__name__} has none')


def refine_predict(image, mask, generator, modulo=8, n_iters=15, lr=0.002,
                   min_side=512, max_scales=3, px_budget=1800000,
                   unpad_to_size=None, gpu_ids=None, mesh=None,
                   return_losses=False):
    """Entry point (reference refine_predict, refinement.py:228-314).
    image: (1, H, W, 3), mask: (1, H, W, 1), NHWC in [0, 1] (numpy or
    tensors); generator: an FFCResNetGenerator in eval mode. Returns the
    inpainted (1, H', W', 3) float32 tensor on the generator's device; H', W'
    are the unpadded size, scaled down when it exceeds px_budget.
    return_losses (a debug aid): also return the Adam-step losses of each
    scale, a list of 1-D CPU tensors (the first empty: that scale has no
    reference). `gpu_ids` is accepted for the reference's configs and
    ignored, as lama_tpu ignores it (refinement.py:168, :178): the
    reference spreads the rear stages over those GPUs to fit their memory
    (refinement.py:266-289 there), and one card holds the whole refiner,
    so the output is the same. `mesh` (spatial sharding) is not ported and
    raises when set."""
    del gpu_ids
    if mesh is not None:
        raise NotImplementedError('refiner mesh (spatial sharding) is not '
                                  'ported yet (ROADMAP queue 1 item 11b)')
    check_refinable(generator)
    device = next(generator.parameters()).device
    image = torch.as_tensor(image).to(device, torch.float32)
    mask = torch.as_tensor(mask).to(device, torch.float32)
    ekernel = _ellipse_kernel(15)
    images, masks = _get_image_mask_pyramid(
        image.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2), unpad_to_size,
        min_side, max_scales, int(px_budget))
    LOGGER.info(f'refining {tuple(images[-1].shape[2:])} in {len(images)} '
                'scales')

    requires_grad = [p.requires_grad for p in generator.parameters()]
    generator.requires_grad_(False)
    losses = []
    try:
        inpainted = None
        for scale_i, (cur_image, cur_mask) in enumerate(zip(images, masks)):
            orig_shape = tuple(int(s) for s in cur_image.shape[2:])
            cur_image = pad_tensor_to_modulo(cur_image, modulo)
            cur_mask = pad_tensor_to_modulo(cur_mask, modulo)
            cur_mask = (cur_mask >= 1e-8).to(cur_image.dtype)
            inpainted, step_losses = _refine_scale(
                generator, cur_image, cur_mask, inpainted, orig_shape,
                int(n_iters), float(lr), ekernel)
            inpainted = inpainted[:, :, :orig_shape[0], :orig_shape[1]]
            losses.append(step_losses)
            first_last = ('' if not len(step_losses) else
                          f', loss {float(step_losses[0]):.6f} -> '
                          f'{float(step_losses[-1]):.6f}')
            LOGGER.info(f'refined scale {scale_i + 1}/{len(images)} '
                        f'({orig_shape[0]}x{orig_shape[1]}){first_last}')
    finally:
        for p, flag in zip(generator.parameters(), requires_grad):
            p.requires_grad_(flag)
    out = inpainted.permute(0, 2, 3, 1)
    return (out, losses) if return_losses else out
