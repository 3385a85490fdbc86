"""The non-saturating adversarial loss with the R1 penalty (counterpart of
lama_tpu/losses/adversarial.py:26-95; reference losses/adversarial.py:81-143).

The JAX package takes R1 with `jax.vjp` over a discriminator closure; here it
is `torch.autograd.grad(..., create_graph=True)` of the real score's sum
with respect to the real images, so the D step's backward differentiates
through it a second time. big-lama (configs/training/big-lama.yaml:14-19):
kind r1, weight 10, gp_coef 0.001, mask_as_fake_target, allow_scale_mask.
Scores arrive as float32 and the losses are taken in float32.
"""
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.precision import widen
from ..ops.resize import interpolate


class NonSaturatingWithR1:
    def __init__(self, gp_coef=5, weight=1, mask_as_fake_target=False,
                 allow_scale_mask=False, mask_scale_mode='nearest',
                 extra_mask_weight_for_gen=0, use_unmasked_for_gen=True,
                 use_unmasked_for_discr=True):
        assert use_unmasked_for_gen or not use_unmasked_for_discr
        assert use_unmasked_for_discr or not mask_as_fake_target
        self.gp_coef = gp_coef
        self.weight = weight
        self.use_unmasked_for_gen = use_unmasked_for_gen
        self.use_unmasked_for_discr = use_unmasked_for_discr
        self.mask_as_fake_target = mask_as_fake_target
        self.allow_scale_mask = allow_scale_mask
        self.mask_scale_mode = mask_scale_mode
        self.extra_mask_weight_for_gen = extra_mask_weight_for_gen

    def interpolate_mask(self, mask, shape):
        """The mask at the score's (h, w): nearest (default) or max pool."""
        if tuple(shape) == tuple(mask.shape[2:]):
            return mask
        assert self.allow_scale_mask
        if self.mask_scale_mode == 'maxpool':
            h, w = mask.shape[2:]
            return F.max_pool2d(mask, (h // shape[0], w // shape[1]))
        return interpolate(mask, size=tuple(shape), mode=self.mask_scale_mode)

    def generator_loss(self, discr_fake_pred, mask=None
                       ) -> Tuple[torch.Tensor, Dict]:
        fake_loss = F.softplus(-discr_fake_pred)
        if ((self.mask_as_fake_target and self.extra_mask_weight_for_gen > 0)
                or not self.use_unmasked_for_gen):
            mask = self.interpolate_mask(mask, discr_fake_pred.shape[2:])
            if not self.use_unmasked_for_gen:
                fake_loss = fake_loss * mask
            else:
                fake_loss = fake_loss * (1 + mask * self.extra_mask_weight_for_gen)
        return fake_loss.mean() * self.weight, {}

    @staticmethod
    def r1_penalty(discr_real_pred, real_batch):
        """Mean over the batch of |d sum(score) / d real|^2; `real_batch`
        must require grad and `discr_real_pred` be computed from it. The
        graph is kept, so the penalty is differentiable w.r.t. the
        discriminator's parameters."""
        grad_real, = torch.autograd.grad(discr_real_pred.sum(), real_batch,
                                         create_graph=True)
        b = grad_real.shape[0]
        return widen(grad_real).reshape(b, -1).square().sum(1).mean()

    def discriminator_loss(self, discr_real_pred, discr_fake_pred,
                           grad_penalty, mask=None) -> Tuple[torch.Tensor, Dict]:
        real_loss = F.softplus(-discr_real_pred)
        gp = grad_penalty * self.gp_coef
        fake_loss = F.softplus(discr_fake_pred)
        if not self.use_unmasked_for_discr or self.mask_as_fake_target:
            mask = self.interpolate_mask(mask, discr_fake_pred.shape[2:])
            fake_loss = fake_loss * mask
            if self.mask_as_fake_target:
                fake_loss = fake_loss + (1 - mask) * F.softplus(-discr_fake_pred)
        loss = (real_loss + fake_loss).mean() + gp
        metrics = dict(discr_real_out=discr_real_pred.mean().detach(),
                       discr_fake_out=discr_fake_pred.mean().detach(),
                       discr_real_gp=gp.detach())
        return loss, metrics


def make_discrim_loss(kind, **kwargs):
    if kind == 'r1':
        return NonSaturatingWithR1(**kwargs)
    if kind == 'bce':
        raise NotImplementedError('adversarial loss kind bce is not ported '
                                  'yet (ROADMAP queue 1 item 10)')
    raise ValueError(f'Unknown adversarial loss kind {kind}')
