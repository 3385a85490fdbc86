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

With a `process_group` (set by parallel/data_parallel.py::sync_batchnorm_)
train mode takes the statistics of the global batch, as lama_tpu's step
over a ('data',) mesh does (its `axis_name` form, norm.py:55-62): per
channel, (sum x, sum x^2, n) in float32 (float64 for a float64 input) are
summed over the ranks by one differentiable all-reduce, then mean = sum x
/ N and var = max(sum x^2 / N - mean^2, 0), the JAX package's own formula.
The running statistics move by the global mean and unbiased variance, so
every rank keeps the same buffers. This path makes a float32 copy of a
bfloat16 activation. Eval mode, or no group, is as above.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.data_parallel import all_reduce_sum
from .precision import widen


class BatchNorm2d(nn.BatchNorm2d):
    process_group = None

    def forward(self, x):
        if self.training:
            self.num_batches_tracked.add_(1)
            if self.process_group is not None:
                return self._global_batch_norm(x)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, self.training,
                            self.momentum, self.eps)

    def _global_batch_norm(self, x):
        x32 = widen(x)
        c = x32.shape[1]
        n = x32.new_full((1,), x32.numel() / c)
        sums = all_reduce_sum(torch.cat([
            x32.sum((0, 2, 3)), x32.square().sum((0, 2, 3)), n]),
            self.process_group)
        total = sums[-1]
        mean = sums[:c] / total
        var = torch.clamp(sums[c:2 * c] / total - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.momentum
            unbiased = var * (total / torch.clamp(total - 1, min=1))
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        shape = (1, c, 1, 1)
        y = (x32 - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        if self.weight is not None:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)
