"""Fake fakes for discriminator regularisation (counterpart of
lama_tpu/models/fake_fakes.py; reference training/modules/fake_fakes.py):
a random gradient blends into each mask a target image that is either
another sample of the batch or the sample itself, randomly rotated and
shifted (reflection padding, as kornia's RandomAffine there).

Drawing and blending are apart: `draw` takes every random number from a
`torch.Generator` into a `FakeFakesDraws`, `__call__` blends by given
draws, so a test can hand the port the JAX package's `jax.random` draws.
"""
import dataclasses
from typing import Tuple

import torch

from ..ops.geometry import draw_random_affine, random_affine


@dataclasses.dataclass
class FakeFakesDraws:
    """mask_affine: (angles, tx, ty) of the gradient's warp (360 degrees,
    translate 0.2, on the 2H x 2W gradient); perm: the batch permutation
    (B,); img_affine: (angles, tx, ty) of the images' warp; is_aug: (B,)
    floats, 1 where the target is the warped image."""
    mask_affine: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    perm: torch.Tensor
    img_affine: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    is_aug: torch.Tensor


class FakeFakesGenerator:
    def __init__(self, aug_proba=0.5, img_aug_degree=30, img_aug_translate=0.2):
        self.aug_proba = aug_proba
        self.img_aug_degree = img_aug_degree
        self.img_aug_translate = img_aug_translate

    def draw(self, gen: torch.Generator, b: int, h: int, w: int
             ) -> FakeFakesDraws:
        mask_affine = draw_random_affine(gen, b, 2 * h, 2 * w, degrees=360.0,
                                         translate=0.2)
        perm = torch.randperm(b, generator=gen)
        img_affine = draw_random_affine(gen, b, h, w, self.img_aug_degree,
                                        self.img_aug_translate)
        is_aug = (torch.rand(b, generator=gen) < self.aug_proba).float()
        return FakeFakesDraws(mask_affine, perm, img_affine, is_aug)

    def __call__(self, draws: FakeFakesDraws, input_images, masks, pool=None):
        """(fake fakes, blend masks), NCHW, from images (B, 3, H, W) and
        masks (B, 1, H, W) (fake_fakes.py:23-28). `draws.perm` indexes
        `pool`, the images a target may be taken from (default: the
        batch; a data-parallel rank passes the global batch)."""
        blend_masks = self._fill_masks_with_gradient(draws, masks)
        blend_target = self._make_blend_target(
            draws, input_images, input_images if pool is None else pool)
        result = input_images * (1 - blend_masks) + blend_target * blend_masks
        return result, blend_masks

    def _make_blend_target(self, draws, input_images, pool):
        permuted = pool[draws.perm.to(pool.device)]
        augmented = random_affine(input_images, *draws.img_affine)
        is_aug = draws.is_aug.to(input_images)[:, None, None, None]
        return augmented * is_aug + permuted * (1 - is_aug)

    def _fill_masks_with_gradient(self, draws, masks):
        b, _, h, w = masks.shape
        ramp = torch.linspace(0, 1, w * 2, dtype=masks.dtype,
                              device=masks.device)
        grad = ramp.expand(b, 1, h * 2, w * 2)
        grad = random_affine(grad, *draws.mask_affine)
        top, left = h // 2, w // 2   # the centre crop back to (h, w)
        grad = grad[:, :, top:top + h, left:left + w] * masks
        grad_for_min = grad + (1 - masks) * 10
        grad = grad - grad_for_min.reshape(b, -1).min(-1)[0][:, None, None, None]
        grad = grad / (grad.reshape(b, -1).max(-1)[0][:, None, None, None] + 1e-6)
        return grad.clamp(0, 1)
