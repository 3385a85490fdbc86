"""The backward pass of every kernel in this package.

The JAX package differentiates its Pallas kernels through the XLA VJP of
their plain versions (lama_tpu/ops/pallas/reflect_conv.py:59-87,
`_diff_wrap`), and none of them has a backward kernel. The port does the
same: `differentiable` runs the kernel forward and, when autograd needs a
gradient, the VJP of the plain version recomputed on the saved inputs.

The JAX bwd is traced XLA code, so a kernel there differentiates twice (the
R1 penalty of a discriminator whose convs are kernels does). Here too:
when autograd records the backward (`create_graph=True`), the plain VJP is
built from the saved inputs themselves, so its own VJP is the plain
version's second derivative. A first-order backward builds it on detached
copies and keeps nothing beyond the gradients.
"""
import torch


class _PlainVJP(torch.autograd.Function):
    """Forward: `kernel_fn(*inputs)`. Backward: the VJP of
    `plain_fn(*inputs)`, recomputed on the saved inputs; differentiable
    again when the backward runs with create_graph=True."""

    @staticmethod
    def forward(ctx, kernel_fn, plain_fn, *inputs):
        ctx.plain_fn = plain_fn
        ctx.save_for_backward(*inputs)
        return kernel_fn(*inputs)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[2:]
        # create_graph=True: the VJP on the inputs' own graph, so autograd
        # can take its derivative in turn; else on detached copies
        create_graph = torch.is_grad_enabled()
        leaves = list(ctx.saved_tensors)
        if not create_graph:
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(leaves, need)]
        with torch.enable_grad():
            out = ctx.plain_fn(*leaves)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(leaves, need) if n], grad,
                create_graph=create_graph))
        return (None, None) + tuple(next(grads) if n else None for n in need)


def needs_grad(*inputs) -> bool:
    """Whether autograd needs a gradient of any of `inputs` (None
    allowed)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)


def differentiable(kernel_fn, plain_fn, *inputs):
    """`kernel_fn(*inputs)`, with the plain version's VJP as its backward
    when autograd needs a gradient of any input (None inputs allowed)."""
    if needs_grad(*inputs):
        return _PlainVJP.apply(kernel_fn, plain_fn, *inputs)
    return kernel_fn(*inputs)


def through_op(op, plain_fn, *inputs):
    """The one path of every kernel wrapper: `op(*inputs)`, a registered op
    of library.py (the kernel on CUDA tensors, the plain version on CPU
    ones), through `differentiable`. A CPU call that needs a gradient takes
    `plain_fn` itself, whose autograd is PyTorch's own."""
    if not inputs[0].is_cuda and needs_grad(*inputs):
        return plain_fn(*inputs)
    return differentiable(op, plain_fn, *inputs)
