"""BatchNorm with the JAX package's semantics (counterpart of
lama_tpu/ops/norm.py:22-74).

`nn.BatchNorm2d` carries the reference's keys (weight, bias, running_mean,
running_var, num_batches_tracked). The normalisation runs in float32
whatever the activation dtype, as in the JAX package (norm.py:48), and
returns the activation dtype: the parameters stay float32, and PyTorch's
batch norm takes a bfloat16 input with float32 parameters and computes in
float32 inside, so no float32 copy of the activation is made.

Eval mode normalises with the running statistics. Train mode (norm.py:51-65)
normalises with the batch's mean and biased variance, both taken in float32,
and moves the running statistics by momentum 0.1 towards the batch mean and
the unbiased variance; PyTorch's batch norm does exactly that. The JAX
package forms the variance as E[x^2] - E[x]^2 and PyTorch by a two-pass or
Welford sum, which differ in rounding only. One divergence: a batch with a
single value per channel raises here (PyTorch's rule), while the JAX package
normalises it to the bias.
"""
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):

    def forward(self, x):
        if self.training:
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, self.training,
                            self.momentum, self.eps)
