"""The GAN training step (counterpart of lama_tpu/training/step.py).

The JAX package fuses both players' updates into one jitted program; here
they run eagerly, in the JAX call order (step.py:267-319):
  1. G step: the generator forward in train mode; masked L1, the
     adversarial loss and feature matching against the discriminator in
     train mode (real images, then the prediction: D's BN statistics move
     twice), and ResNetPL; backward into the generator only; clip; step.
  2. a fresh generator forward in train mode with the updated weights,
     without gradients (the generator's BN statistics move again);
  3. D step: the real images with the R1 penalty, then the prediction. The
     R1 forward is the only real pass, so D's statistics move once for the
     reals and once for the fakes, as in the JAX step, whose two real
     passes XLA merges;
  4. the generator EMA (step.py:303-311), when enabled.
Tensors are NCHW: image (B, 3, H, W) in [0, 1], mask (B, 1, H, W) in {0, 1}.
Options that big-lama does not use raise NotImplementedError naming their
ROADMAP item.
"""
import dataclasses
from typing import Dict, Optional

import torch

from ..losses.feature_matching import feature_matching_loss, masked_l1_loss
from ..ops.precision import widen
from .state import TrainState, clip_grad_norm

_ITEM10 = 'not ported yet (ROADMAP queue 1 item 10)'


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights (configs/training/big-lama.yaml:7-24)."""
    l1_weight_known: float = 10.0
    l1_weight_missing: float = 0.0
    feature_matching_weight: float = 100.0
    feature_matching_pass_mask: bool = False
    resnet_pl_weight: float = 30.0
    perceptual_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    """reference trainers/base.py:92-97."""
    enabled: bool = True
    beta: float = 0.999
    start_step: int = 30000
    period: int = 10


class InpaintingTrainStep:
    """`__call__(state, image, mask) -> metrics` (0-d tensors on the
    device, not synchronised). `generator_loss` and `discriminator_loss` are
    the two players' objectives, which the tests and chip_smoke.py also
    call on their own."""

    def __init__(self, adversarial, loss_config: LossConfig = LossConfig(),
                 ema: EMAConfig = EMAConfig(), perceptual_fn=None,
                 concat_mask: bool = True,
                 image_to_discriminator: str = 'predicted_image',
                 clip_grad_norm: Optional[float] = None,
                 vgg_perceptual: bool = False, distance_weighter=None,
                 fake_fakes_proba: float = 0.0, add_noise_kwargs=None,
                 r1_every: int = 1):
        for name, on in (('losses.perceptual (the VGG19 perceptual loss)',
                          vgg_perceptual and loss_config.perceptual_weight > 0),
                         ('distance_weighter_kwargs',
                          distance_weighter is not None),
                         ('fake_fakes_proba', fake_fakes_proba > 1e-3),
                         ('add_noise_kwargs', bool(add_noise_kwargs)),
                         ('r1_every > 1 (lazy R1)', int(r1_every) > 1)):
            if on:
                raise NotImplementedError(f'{name} is {_ITEM10}')
        if image_to_discriminator not in ('predicted_image', 'inpainted'):
            raise ValueError(f'image_to_discriminator={image_to_discriminator!r}')
        self.adversarial = adversarial
        self.loss_config = loss_config
        self.ema = ema
        self.perceptual_fn = perceptual_fn
        self.concat_mask = concat_mask
        self.image_to_discriminator = image_to_discriminator
        self.clip = clip_grad_norm

    def generator_input(self, img, mask):
        masked = img * (1 - mask)
        return torch.cat([masked, mask], dim=1) if self.concat_mask else masked

    def to_discriminator(self, pred, img, mask):
        """batch[image_to_discriminator] (trainers/default.py:90,144)."""
        if self.image_to_discriminator == 'inpainted':
            return mask * pred + (1 - mask) * img
        return pred

    def generator_loss(self, generator, discriminator, img, mask):
        """(total, metrics): the G objective of one batch. The real
        discriminator pass runs without gradients (its features are
        constants of the G objective)."""
        cfg = self.loss_config
        pred = widen(generator(self.generator_input(img, mask)))
        predicted_img = self.to_discriminator(pred, img, mask)
        l1 = masked_l1_loss(predicted_img, img, mask, cfg.l1_weight_known,
                            cfg.l1_weight_missing)
        total, metrics = l1, {'gen_l1': l1.detach()}
        with torch.no_grad():
            _, real_feats = discriminator(img)
        fake_score, fake_feats = discriminator(predicted_img)
        adv, adv_metrics = self.adversarial.generator_loss(widen(fake_score),
                                                           mask)
        total = total + adv
        metrics['gen_adv'] = adv.detach()
        metrics.update({f'adv_{k}': v for k, v in adv_metrics.items()})
        if cfg.feature_matching_weight > 0:
            fm = feature_matching_loss(
                [widen(f) for f in fake_feats], [widen(f) for f in real_feats],
                mask=mask if cfg.feature_matching_pass_mask else None
            ) * cfg.feature_matching_weight
            total = total + fm
            metrics['gen_fm'] = fm.detach()
        if self.perceptual_fn is not None and cfg.resnet_pl_weight > 0:
            pl = self.perceptual_fn(predicted_img, img) * cfg.resnet_pl_weight
            total = total + pl
            metrics['gen_resnet_pl'] = pl.detach()
        return total, metrics

    def discriminator_loss(self, discriminator, img, pred, mask):
        """(total, metrics): the D objective, R1 on the reals included."""
        real = img.detach().requires_grad_(True)
        real_score, _ = discriminator(real)
        gp = self.adversarial.r1_penalty(real_score, real)
        fake_score, _ = discriminator(pred.detach())
        loss, metrics = self.adversarial.discriminator_loss(
            widen(real_score), widen(fake_score), gp, mask)
        return loss, metrics

    def __call__(self, state: TrainState, img, mask) -> Dict[str, torch.Tensor]:
        gen, disc = state.generator, state.discriminator
        gen.train()
        disc.train()

        # ---- generator step
        state.g_opt.zero_grad(set_to_none=True)
        disc.requires_grad_(False)
        try:
            g_total, metrics = self.generator_loss(gen, disc, img, mask)
            g_total.backward()
        finally:
            disc.requires_grad_(True)
        if self.clip:
            clip_grad_norm(list(gen.parameters()), self.clip)
        state.g_opt.step()
        metrics['gen_total'] = g_total.detach()

        # ---- discriminator step, on a fresh forward of the updated G
        with torch.no_grad():
            pred = self.to_discriminator(
                widen(gen(self.generator_input(img, mask))), img, mask)
        state.d_opt.zero_grad(set_to_none=True)
        d_total, d_metrics = self.discriminator_loss(disc, img, pred, mask)
        d_total.backward()
        if self.clip:
            clip_grad_norm(list(disc.parameters()), self.clip)
        state.d_opt.step()
        metrics.update(d_metrics)
        metrics['discr_total'] = d_total.detach()

        # ---- generator EMA
        if self.ema.enabled and state.ema is not None:
            if (state.step >= self.ema.start_step
                    and state.step % self.ema.period == 0):
                with torch.no_grad():
                    torch._foreach_lerp_(state.ema, list(gen.parameters()),
                                         1.0 - self.ema.beta)
        state.step += 1
        return metrics
