"""`_PlainVJP`, the backward of every kernel wrapper, differentiates twice.

On a CUDA tensor each kernel wrapper runs inside `_autograd.differentiable`
(forward: the kernel; backward: the plain version's VJP). The R1 penalty of
a discriminator whose convs are kernels (the FFC discriminator's reflect
convs) takes a gradient of that backward. On the CPU the wrappers take
their plain version directly and never reach the Function, so these tests
apply it themselves, with the plain version as both kernel and plain
function, in float64: `gradcheck` and `gradgradcheck` for each
reflect-conv plain version (3x3 stride 1 and 2, the 7x7 head, and the
tiled halo conv's k in {3, 7} x stride in {1, 2}), with and without a
bias and with the input or the weight alone requiring a gradient.
"""
import functools

import pytest
import torch

from lama_tpu_torch.ops.kernels import halo_conv as hc
from lama_tpu_torch.ops.kernels import reflect_conv as rc
from lama_tpu_torch.ops.kernels._autograd import _PlainVJP, differentiable

torch.set_num_threads(1)

PLAIN = {
    '3x3_s1': (rc.reflect_conv_plain, 3, 3, 4),
    '3x3_s2': (rc.reflect_down_conv3x3_plain, 3, 4, 4),
    '7x7_head': (rc.reflect_conv_plain, 7, 4, 2),
    'halo3x3': (hc.halo_conv3x3_reflect_plain, 3, 3, 5),
    'tiled_k3_s1': (functools.partial(rc.reflect_conv_plain, stride=1), 3, 2, 3),
    'tiled_k3_s2': (functools.partial(rc.reflect_conv_plain, stride=2), 3, 2, 3),
    'tiled_k7_s1': (functools.partial(rc.reflect_conv_plain, stride=1), 7, 2, 3),
    'tiled_k7_s2': (functools.partial(rc.reflect_conv_plain, stride=2), 7, 2, 3),
}


def _inputs(k, c, co, bias, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(1, c, 6, 7, generator=g, dtype=torch.float64)
    w = torch.randn(co, c, k, k, generator=g, dtype=torch.float64) / k
    b = torch.randn(co, generator=g, dtype=torch.float64) if bias else None
    return x, w, b


@pytest.mark.parametrize('bias', [True, False], ids=['bias', 'nobias'])
@pytest.mark.parametrize('name', sorted(PLAIN))
def test_plain_vjp_is_twice_differentiable(name, bias):
    plain, k, c, co = PLAIN[name]
    x, w, b = _inputs(k, c, co, bias)
    leaves = [t.requires_grad_() for t in (x, w, b) if t is not None]

    def f(*args):
        x, w = args[:2]
        return _PlainVJP.apply(plain, plain, x, w, args[2] if bias else None)

    assert torch.autograd.gradcheck(f, leaves)
    assert torch.autograd.gradgradcheck(f, leaves)


@pytest.mark.parametrize('which', ['input', 'weight'])
def test_plain_vjp_second_order_with_one_input_requiring_grad(which):
    plain, k, c, co = PLAIN['3x3_s2']
    x, w, b = _inputs(k, c, co, True, seed=1)
    (x if which == 'input' else w).requires_grad_()
    f = (lambda x_: _PlainVJP.apply(plain, plain, x_, w, b)) if which == 'input' \
        else (lambda w_: _PlainVJP.apply(plain, plain, x, w_, b))
    arg = x if which == 'input' else w
    assert torch.autograd.gradgradcheck(f, (arg,))


def test_r1_through_the_function_matches_plain_autograd():
    """An R1-style penalty (|d sum(out) / d x|^2) and its gradient w.r.t.
    the weight, through the Function and through plain autograd."""
    plain = rc.reflect_conv_plain
    x, w, b = _inputs(3, 3, 4, True, seed=2)

    def penalty_grad(fn):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = fn(xr, wr)
        gx, = torch.autograd.grad((out * out).sum(), xr, create_graph=True)
        gw, = torch.autograd.grad(gx.square().sum(), wr)
        return gx.detach(), gw

    ours = penalty_grad(lambda xr, wr: differentiable(plain, plain, xr, wr, b))
    ref = penalty_grad(lambda xr, wr: plain(xr, wr, b))
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)


def test_first_order_backward_keeps_no_graph():
    plain = rc.reflect_conv_plain
    x, w, b = _inputs(3, 3, 4, True, seed=3)
    x.requires_grad_()
    w.requires_grad_()
    out = _PlainVJP.apply(plain, plain, x, w, b)
    gx, gw = torch.autograd.grad(out.sum(), (x, w))
    assert gx.grad_fn is None and gw.grad_fn is None
    assert not gx.requires_grad and not gw.requires_grad
