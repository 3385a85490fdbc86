"""Gatys-style VGG19 content loss (counterpart of lama_tpu/losses/style.py;
reference losses/style_loss.py:6-155, no shipped config uses it): the L1
distances between the relu{1..5}_1 activations of the max-pool VGG19 trunk,
frozen, in float32, summed with weight 1 each. Weights: the torchvision
vgg19 file at $LAMA_VGG19_WEIGHTS, as the perceptual loss reads it, else
seeded random ones with a warning."""
import os

import torch.nn as nn

from ..models.aux.vgg import (VGG19_CFG, VGGFeatures, load_trunk_weights,
                              relu_taps)


class StylePerceptualLoss(nn.Module):
    def __init__(self):
        super().__init__()
        self.model = load_trunk_weights(
            VGGFeatures(VGG19_CFG, relu_taps(VGG19_CFG, first_in_stage=True),
                        pool='max'), os.environ.get('LAMA_VGG19_WEIGHTS'),
            'StylePerceptualLoss')
        self.model.eval().requires_grad_(False)

    def train(self, mode=True):
        """The trunk is frozen: it stays in eval mode."""
        return self

    def forward(self, x, y):
        fx, fy = self.model(x.float()), self.model(y.float())
        return sum((a - b).abs().mean() for a, b in zip(fx, fy))
