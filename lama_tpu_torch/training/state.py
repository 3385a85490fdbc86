"""Training state: both GAN players, their optimizers and the generator EMA
(counterpart of lama_tpu/training/state.py).

The JAX package keeps these in one immutable pytree; here the modules and
optimizers hold their own tensors and update them in place, and `TrainState`
only groups them with the step counter.
"""
import dataclasses
from typing import List, Optional

import torch


def make_optimizer(params, kind='adamw', lr=1e-3, beta1=0.9, beta2=0.999,
                   eps=1e-8, weight_decay=0.01, **kwargs):
    """The JAX package's optimizer factory (state.py:17-31), with torch's
    defaults: Adam and AdamW apply the same update as optax's (bias-corrected
    moments, eps outside the square root; AdamW decays the pre-step weights
    by lr * weight_decay). The gradient clip is separate (`clip_grad_norm`)."""
    if kind == 'adam':
        return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=eps)
    if kind == 'adamw':
        return torch.optim.AdamW(params, lr=lr, betas=(beta1, beta2), eps=eps,
                                 weight_decay=weight_decay)
    if kind == 'sgd':
        return torch.optim.SGD(params, lr=lr, **kwargs)
    raise ValueError(f'Unknown optimizer kind {kind}')


@torch.no_grad()
def clip_grad_norm(params, max_norm: float):
    """optax.clip_by_global_norm (the JAX package's Lightning
    gradient_clip_val): when the global L2 norm of the gradients is at
    least max_norm, scale them by max_norm / norm. Unlike
    torch.nn.utils.clip_grad_norm_, no epsilon joins the norm. Stays on the
    device (no host sync). Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))
    return norm


@dataclasses.dataclass
class TrainState:
    generator: torch.nn.Module
    discriminator: torch.nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    ema: Optional[List[torch.Tensor]] = None   # generator parameter copies
    step: int = 0

    def state_dict(self):
        """{'state_dict': {'generator.*', 'discriminator.*' and, with the
        EMA, 'generator_average.*'}, 'optimizer_states': [G, D],
        'global_step'}: the reference's Lightning layout, which
        lama_tpu_torch.convert.load_checkpoint reads."""
        sd = {f'generator.{k}': v for k, v in
              self.generator.state_dict().items()}
        sd.update({f'discriminator.{k}': v for k, v in
                   self.discriminator.state_dict().items()})
        if self.ema is not None:
            names = [n for n, _ in self.generator.named_parameters()]
            sd.update({f'generator_average.{n}': t
                       for n, t in zip(names, self.ema)})
        return {'state_dict': sd,
                'optimizer_states': [self.g_opt.state_dict(),
                                     self.d_opt.state_dict()],
                'global_step': self.step}

    def load_state_dict(self, ckpt):
        sd = ckpt['state_dict']
        for prefix, module in (('generator.', self.generator),
                               ('discriminator.', self.discriminator)):
            module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                    if k.startswith(prefix)}, strict=True)
        self.g_opt.load_state_dict(ckpt['optimizer_states'][0])
        self.d_opt.load_state_dict(ckpt['optimizer_states'][1])
        if self.ema is not None:
            with torch.no_grad():
                for (n, _), t in zip(self.generator.named_parameters(),
                                     self.ema):
                    t.copy_(sd[f'generator_average.{n}'])
        self.step = int(ckpt['global_step'])
