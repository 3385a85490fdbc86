"""The backward pass of every kernel in this package.

The JAX package differentiates its Pallas kernels through the XLA VJP of
their plain versions (lama_tpu/ops/pallas/reflect_conv.py:59-87,
`_diff_wrap`), and none of them has a backward kernel. The port does the
same: `differentiable` runs the kernel forward and, when autograd needs a
gradient, the VJP of the plain version recomputed on the saved inputs.
"""
import torch
from torch.autograd.function import once_differentiable


class _PlainVJP(torch.autograd.Function):
    """Forward: `kernel_fn(*inputs)`. Backward: the VJP of
    `plain_fn(*inputs)`, recomputed on the saved inputs. Once
    differentiable: a second-order gradient raises."""

    @staticmethod
    def forward(ctx, kernel_fn, plain_fn, *inputs):
        ctx.plain_fn = plain_fn
        ctx.save_for_backward(*inputs)
        return kernel_fn(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain_fn(*leaves)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(leaves, need) if n], grad))
        return (None, None) + tuple(next(grads) if n else None for n in need)


def differentiable(kernel_fn, plain_fn, *inputs):
    """`kernel_fn(*inputs)`, with the plain version's VJP as its backward
    when autograd needs a gradient of any input (None inputs allowed)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        return _PlainVJP.apply(kernel_fn, plain_fn, *inputs)
    return kernel_fn(*inputs)
