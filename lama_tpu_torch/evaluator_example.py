"""Smoke example of the evaluator: `python -m lama_tpu_torch.evaluator_example
[--cpu]`, the counterpart of bin/evaluator_example.py (reference
bin/evaluator_example.py).

A constant-fill 'model' over a synthetic dataset of seeded random images
with centred square masks, run through the port's InpaintingEvaluator with
SSIM on the card (--cpu: on the CPU). Prints each (score, group) with its
values rounded to 4 places, as the JAX CLI does.
"""
import sys

import numpy as np

from .evaluation.evaluator import InpaintingEvaluator
from .evaluation.scores import SSIMScore
from .predict import resolve_device


class SimpleDataset:
    """Random images with centred square masks (bin/evaluator_example.py
    :14-31)."""

    def __init__(self, n=16, size=64):
        self.n = n
        self.size = size

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        img = rng.rand(self.size, self.size, 3).astype(np.float32)
        mask = np.zeros((self.size, self.size, 1), np.float32)
        q = self.size // 4 + (i % 4) * 2
        mask[q:-q or None, q:-q or None] = 1
        return dict(image=img, mask=mask)


def constant_fill_model(image_batch, mask_batch, fill_value=0.5):
    """The 'model': fills the hole with a constant (reference Model class)."""
    return image_batch * (1 - mask_batch) + fill_value * mask_batch


def main(argv=()):
    device = resolve_device('cpu' if '--cpu' in argv else 'cuda')
    evaluator = InpaintingEvaluator(SimpleDataset(),
                                    scores={'ssim': SSIMScore(device=device)},
                                    batch_size=4)
    results = evaluator.evaluate(model=constant_fill_model)
    for key, value in sorted(results.items()):
        print(key, {k: round(float(v), 4) for k, v in value.items()})
    return results


if __name__ == '__main__':
    main(sys.argv[1:])
