"""The GAN training step (counterpart of lama_tpu/training/step.py).

The JAX package fuses both players' updates into one jitted program; here
they run eagerly, in the JAX call order (step.py:267-319):
  1. G step: the generator forward in train mode; masked L1, the VGG19
     perceptual loss, the adversarial loss and feature matching against the
     discriminator in train mode (real images, then the prediction: D's BN
     statistics move twice), and ResNetPL; backward into the generator
     only; clip; step. A distance weighter, if set, reweights the mask of
     L1, the VGG19 loss and feature matching (and of the adversarial G loss
     with `distance_weighted_mask_for_discr`).
  2. a fresh generator forward in train mode with the updated weights,
     without gradients (the generator's BN statistics move again);
  3. D step: the real images with the R1 penalty (on steps where
     `step % r1_every == 0`, times r1_every; a plain real pass on the
     others), then the prediction, then, when this step's fake-fakes draw
     is 1, the fake fakes, whose loss term (R1 and the real term again, as
     the reference's) is added. The R1 forward is the only real pass, so
     D's statistics move once for the reals and once for each fake pass, as
     in the JAX step, whose two real passes XLA merges;
  4. the generator EMA (step.py:303-311), when enabled.
Tensors are NCHW: image (B, 3, H, W) in [0, 1], mask (B, 1, H, W) in {0, 1}.

Randomness (the input noise of each generator forward, the fake-fakes draw
and its warps) is drawn apart from its use (`draw` -> `StepDraws`), from
`torch.Generator`s seeded from (seed, step): noise on the device, the rest
on the host, so each branch is taken on a host value. The JAX step keys
the same draws by `jax.random.PRNGKey(step)` (trainer.py:447), which
torch cannot reproduce; the tests hand `__call__` the JAX draws instead.

Data parallel (`group`, a process group; parallel/data_parallel.py): each
rank steps on its rows of the global batch and the step computes what
lama_tpu's step over a ('data',) mesh computes on the whole of it
(mesh.py:88-103). The modules' BatchNorms take global statistics
(`sync_batchnorm_`, set by the trainer); after each player's backward the
gradients are averaged over the ranks, then clipped, then stepped; the
draws are made for the global batch, the same on every rank, and each
rank keeps its rows, and the fake fakes permute the global batch. The
metrics stay this rank's means; the trainer averages them.
"""
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..losses.feature_matching import feature_matching_loss, masked_l1_loss
from ..models.fake_fakes import FakeFakesDraws
from ..ops.precision import widen
from ..ops.resize import interpolate
from ..parallel.data_parallel import (allreduce_grads_, gather_rows,
                                      global_rows, rank_and_world)
from .state import TrainState, clip_grad_norm


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


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one step: the noise samples of the G step's
    and of the D step's generator forward (`draw_multiscale_noise`), the
    fake-fakes Bernoulli draw and, when it is 1, the fake fakes' draws."""
    g_noise: Optional[List[torch.Tensor]] = None
    d_noise: Optional[List[torch.Tensor]] = None
    use_ff: bool = False
    ff: Optional[FakeFakesDraws] = None


def step_seed(seed: int, step: int, stream: int) -> int:
    """The seed of one stream of one step's draws."""
    return int(np.random.SeedSequence([seed, step, stream]).generate_state(1)[0])


def draw_multiscale_noise(gen: torch.Generator, b, h, w, scales=6,
                          device=None) -> List[torch.Tensor]:
    """The random part of `multiscale_noise`: standard normal float32
    samples (B, 1, h_i, w_i), halving h and w at each scale (step.py:38-52,
    `jax.random.normal(fold_in(key, i))` there)."""
    out = []
    for _ in range(scales):
        out.append(torch.randn((b, 1, h, w), generator=gen, device=device))
        h //= 2
        w //= 2
    return out


def multiscale_noise(samples, size, scale_mode='bilinear'):
    """The noise pyramid (reference trainers/base.py:43-55): each sample
    resized to `size`, concatenated on channels."""
    return torch.cat([interpolate(s, size=tuple(size), mode=scale_mode)
                      for s in samples], dim=1)


class InpaintingTrainStep:
    """`__call__(state, image, mask, draws=None) -> metrics` (0-d tensors
    on the device, not synchronised). `generator_loss` and
    `discriminator_loss` are the two players' objectives, which the tests
    and chip_smoke.py also call on their own."""

    def __init__(self, adversarial, loss_config: LossConfig = LossConfig(),
                 ema: EMAConfig = EMAConfig(), perceptual_fn=None,
                 vgg_perceptual_fn=None, concat_mask: bool = True,
                 image_to_discriminator: str = 'predicted_image',
                 clip_grad_norm: Optional[float] = None,
                 distance_weighter=None,
                 distance_weighted_mask_for_discr: bool = False,
                 fake_fakes_proba: float = 0.0, fake_fakes_gen=None,
                 add_noise_kwargs=None, noise_fill_hole: bool = False,
                 r1_every: int = 1, seed: int = 0, group=None):
        if image_to_discriminator not in ('predicted_image', 'inpainted'):
            raise ValueError(f'image_to_discriminator={image_to_discriminator!r}')
        if fake_fakes_proba > 1e-3 and fake_fakes_gen is None:
            raise ValueError('fake_fakes_proba > 0 needs fake_fakes_gen')
        self.adversarial = adversarial
        self.loss_config = loss_config
        self.ema = ema
        self.perceptual_fn = perceptual_fn
        self.vgg_perceptual_fn = vgg_perceptual_fn
        self.concat_mask = concat_mask
        self.image_to_discriminator = image_to_discriminator
        self.clip = clip_grad_norm
        self.distance_weighter = distance_weighter
        self.distance_weighted_mask_for_discr = distance_weighted_mask_for_discr
        self.fake_fakes_proba = fake_fakes_proba
        self.fake_fakes_gen = fake_fakes_gen
        self.add_noise_kwargs = dict(add_noise_kwargs) if add_noise_kwargs else None
        self.noise_fill_hole = noise_fill_hole
        self.r1_every = int(r1_every)
        self.seed = int(seed)
        self.group = group
        self.rank, self.world = rank_and_world(group)

    # ------------------------------------------------------------- draws
    def _noise(self, gen, img, world=1):
        b, _, h, w = img.shape
        return draw_multiscale_noise(
            gen, b * world, h, w, self.add_noise_kwargs.get('scales', 6),
            img.device)

    def draw(self, step: int, img) -> StepDraws:
        """This step's draws for a batch shaped like `img`: made for the
        global batch (world x its rows), the same on every rank, and cut to
        this rank's rows."""
        draws = StepDraws()
        rank, world = self.rank, self.world
        if self.add_noise_kwargs is not None:
            dev = torch.Generator(img.device).manual_seed(
                step_seed(self.seed, step, 1))
            draws.g_noise = [global_rows(t, rank, world)
                             for t in self._noise(dev, img, world)]
            draws.d_noise = [global_rows(t, rank, world)
                             for t in self._noise(dev, img, world)]
        if self.fake_fakes_proba > 1e-3:
            host = torch.Generator().manual_seed(step_seed(self.seed, step, 0))
            draws.use_ff = bool(torch.rand((), generator=host)
                                < self.fake_fakes_proba)
            if draws.use_ff:
                b, _, h, w = img.shape
                ff = self.fake_fakes_gen.draw(host, b * world, h, w)
                rows = lambda t: global_rows(t, rank, world)
                draws.ff = FakeFakesDraws(
                    tuple(map(rows, ff.mask_affine)), rows(ff.perm),
                    tuple(map(rows, ff.img_affine)), rows(ff.is_aug))
        return draws

    def eval_noise(self, img):
        """The input noise of an eval-mode forward: fixed, as the JAX
        trainer's PRNGKey(0) (trainer.py:363-369); None without noise."""
        if self.add_noise_kwargs is None:
            return None
        return self._noise(torch.Generator(img.device).manual_seed(0), img)

    # ------------------------------------------------------------- inputs
    def generator_input(self, img, mask, noise=None):
        """The masked image, then the noise pyramid of `noise` (with
        add_noise_kwargs; added into the hole too with noise_fill_hole),
        then the mask (step.py:134-145)."""
        masked = img * (1 - mask)
        if self.add_noise_kwargs is not None:
            if noise is None:
                raise ValueError('add_noise_kwargs: the generator input needs '
                                 'its noise samples')
            pyramid = multiscale_noise(
                noise, img.shape[2:],
                self.add_noise_kwargs.get('scale_mode', 'bilinear')).to(masked)
            if self.noise_fill_hole:
                masked = masked + mask * pyramid[:, :masked.shape[1]]
            masked = torch.cat([masked, pyramid], dim=1)
        return torch.cat([masked, mask], dim=1) if self.concat_mask else masked

    def to_discriminator(self, pred, img, mask):
        """batch[image_to_discriminator] (trainers/default.py:90,144)."""
        if self.image_to_discriminator == 'inpainted':
            return mask * pred + (1 - mask) * img
        return pred

    # ------------------------------------------------------------- losses
    def generator_loss(self, generator, discriminator, img, mask, noise=None):
        """(total, metrics): the G objective of one batch. The real
        discriminator pass runs without gradients (its features are
        constants of the G objective)."""
        cfg = self.loss_config
        pred = widen(generator(self.generator_input(img, mask, noise)))
        supervised_mask = (mask if self.distance_weighter is None
                           else self.distance_weighter(img, pred, mask))
        predicted_img = self.to_discriminator(pred, img, mask)
        l1 = masked_l1_loss(predicted_img, img, supervised_mask,
                            cfg.l1_weight_known, cfg.l1_weight_missing)
        total, metrics = l1, {'gen_l1': l1.detach()}
        if self.vgg_perceptual_fn is not None and cfg.perceptual_weight > 0:
            pl = self.vgg_perceptual_fn(predicted_img, img, supervised_mask
                                        ).sum() * cfg.perceptual_weight
            total = total + pl
            metrics['gen_pl'] = pl.detach()
        with torch.no_grad():
            _, real_feats = discriminator(img)
        fake_score, fake_feats = discriminator(predicted_img)
        adv, adv_metrics = self.adversarial.generator_loss(
            widen(fake_score), supervised_mask
            if self.distance_weighted_mask_for_discr else mask)
        total = total + adv
        metrics['gen_adv'] = adv.detach()
        metrics.update({f'adv_{k}': v for k, v in adv_metrics.items()})
        if cfg.feature_matching_weight > 0:
            fm = feature_matching_loss(
                [widen(f) for f in fake_feats], [widen(f) for f in real_feats],
                mask=supervised_mask if cfg.feature_matching_pass_mask else None
            ) * cfg.feature_matching_weight
            total = total + fm
            metrics['gen_fm'] = fm.detach()
        if self.perceptual_fn is not None and cfg.resnet_pl_weight > 0:
            pl = self.perceptual_fn(predicted_img, img) * cfg.resnet_pl_weight
            total = total + pl
            metrics['gen_resnet_pl'] = pl.detach()
        return total, metrics

    def discriminator_loss(self, discriminator, img, pred, mask,
                           take_r1: bool = True, fake_fakes=None):
        """(total, metrics): the D objective. With `take_r1` (and an
        adversarial loss that has one) the R1 penalty on the reals, times
        r1_every when that is above 1 (step.py:228-240); without, a plain
        real pass and 0. With `fake_fakes`, the extra term on them
        (step.py:249-262)."""
        if take_r1 and self.adversarial.has_r1:
            real = img.detach().requires_grad_(True)
            real_score, _ = discriminator(real)
            gp = self.adversarial.r1_penalty(real_score, real)
            if self.r1_every > 1:
                gp = gp * float(self.r1_every)
        else:
            real_score, _ = discriminator(img.detach())
            gp = torch.zeros((), dtype=torch.float32, device=img.device)
        fake_score, _ = discriminator(pred.detach())
        real_score = widen(real_score)
        loss, metrics = self.adversarial.discriminator_loss(
            real_score, widen(fake_score), gp, mask)
        if fake_fakes is not None:
            ff_score, _ = discriminator(fake_fakes.detach())
            ff_loss, _ = self.adversarial.discriminator_loss(
                real_score, widen(ff_score), gp, mask)
            loss = loss + ff_loss
            metrics['discr_adv_fake_fakes'] = ff_loss.detach()
        elif self.fake_fakes_proba > 1e-3:
            metrics['discr_adv_fake_fakes'] = torch.zeros_like(loss).detach()
        return loss, metrics

    # --------------------------------------------------------------- step
    def __call__(self, state: TrainState, img, mask,
                 draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = self.draw(state.step, img)
        gen, disc = state.generator, state.discriminator
        gen.train()
        disc.train()

        # ---- generator step
        state.g_opt.zero_grad(set_to_none=True)
        disc.requires_grad_(False)
        try:
            g_total, metrics = self.generator_loss(gen, disc, img, mask,
                                                   draws.g_noise)
            g_total.backward()
        finally:
            disc.requires_grad_(True)
        if self.group is not None:
            allreduce_grads_(gen.parameters(), self.group)
        if self.clip:
            clip_grad_norm(list(gen.parameters()), self.clip)
        state.g_opt.step()
        metrics['gen_total'] = g_total.detach()

        # ---- discriminator step, on a fresh forward of the updated G
        with torch.no_grad():
            pred = self.to_discriminator(
                widen(gen(self.generator_input(img, mask, draws.d_noise))),
                img, mask)
            fake_fakes = (self.fake_fakes_gen(
                draws.ff, img, mask, pool=gather_rows(img, self.group))[0]
                if draws.use_ff else None)
        state.d_opt.zero_grad(set_to_none=True)
        d_total, d_metrics = self.discriminator_loss(
            disc, img, pred, mask, take_r1=state.step % self.r1_every == 0,
            fake_fakes=fake_fakes)
        d_total.backward()
        if self.group is not None:
            allreduce_grads_(disc.parameters(), self.group)
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
