"""Eval-mode BatchNorm (counterpart of lama_tpu/ops/norm.py:22-74).

`nn.BatchNorm2d` carries the reference's keys (weight, bias, running_mean,
running_var, num_batches_tracked). The normalisation runs in float32
whatever the activation dtype, as in the JAX package (norm.py:48), and
returns the activation dtype: the parameters stay float32, and PyTorch's
batch norm takes a bfloat16 input with float32 parameters and computes in
float32 inside, so no float32 copy of the activation is made. Train mode
(batch statistics) belongs to the training slice and raises.
"""
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                'BatchNorm2d train mode is not ported yet (ROADMAP queue 1 '
                'item 2); call .eval() first')
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)
