"""The non-saturating adversarial loss with the R1 penalty (counterpart of
lama_tpu/losses/adversarial.py:26-95; reference losses/adversarial.py:81-143)
and the mask-target BCE loss (adversarial.py:98-125; reference :145-169).

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
    has_r1 = True

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


def _bce_with_logits(pred, target):
    """Mean binary cross-entropy of logits, in lama_tpu's stable form."""
    return (pred.clamp(min=0) - pred * target
            + torch.log1p(torch.exp(-pred.abs()))).mean()


class BCEAdversarialLoss(NonSaturatingWithR1):
    """kind bce: the discriminator learns the mask (0 on real pixels, the
    mask on the fakes' score map), the generator drives the fakes' scores
    to 0; no gradient penalty (`has_r1` False: the step takes no R1 pass).
    As lama_tpu's, its keyword arguments are `weight` only, plus the mask
    scaling of the r1 loss (`allow_scale_mask`, `mask_scale_mode`): the
    reference's and lama_tpu's BCE use the mask at the image's size, which
    a PatchGAN's smaller score map cannot take (lama_tpu's raises there);
    here the mask is resized to the score map as the r1 loss resizes it."""
    has_r1 = False

    def __init__(self, weight=1, allow_scale_mask=False,
                 mask_scale_mode='nearest'):
        self.weight = weight
        self.allow_scale_mask = allow_scale_mask
        self.mask_scale_mode = mask_scale_mode

    def generator_loss(self, discr_fake_pred, mask=None):
        fake = widen(discr_fake_pred)
        return _bce_with_logits(fake, torch.zeros_like(fake)) * self.weight, {}

    @staticmethod
    def r1_penalty(discr_real_pred, real_batch):
        return torch.zeros((), dtype=torch.float32,
                           device=discr_real_pred.device)

    def discriminator_loss(self, discr_real_pred, discr_fake_pred,
                           grad_penalty, mask=None):
        mask = self.interpolate_mask(mask, discr_fake_pred.shape[2:])
        loss = (_bce_with_logits(discr_real_pred,
                                 torch.zeros_like(discr_real_pred))
                + _bce_with_logits(discr_fake_pred, mask)) / 2
        metrics = dict(discr_real_out=discr_real_pred.mean().detach(),
                       discr_fake_out=discr_fake_pred.mean().detach(),
                       discr_real_gp=torch.zeros_like(loss).detach())
        return loss, metrics


def make_discrim_loss(kind, **kwargs):
    if kind == 'r1':
        return NonSaturatingWithR1(**kwargs)
    if kind == 'bce':
        return BCEAdversarialLoss(**kwargs)
    raise ValueError(f'Unknown adversarial loss kind {kind}')
