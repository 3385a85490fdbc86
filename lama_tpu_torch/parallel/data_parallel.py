"""Data parallelism over a process group (counterpart of the trainer's
('data',) mesh, lama_tpu/parallel/mesh.py:61-155).

lama_tpu jits one step over the global batch (`shard_train_step`) and XLA
inserts every collective: the gradient is that of the global mean loss,
the clip sees it, and each train-mode BatchNorm takes its statistics over
the global batch. The port runs one process per card, each on its rows of
the global batch, and these plain functions give the same step:
`replicate_` starts every rank from rank 0's weights (`put_replicated`),
`allreduce_grads_` averages the gradients between backward and the clip,
`sync_batchnorm_` gives the BatchNorms their global statistics
(ops/norm.py), and `global_rows` / `gather_rows` cut a draw made for the
global batch to this rank's rows and gather the rows back. There is no DDP
wrapper: its reducer hooks the first backward, and the R1 penalty takes a
gradient of a gradient.

All collectives are all-reduces and broadcasts, which gloo also runs on
CUDA tensors.
"""
from typing import Iterable, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

BUCKET_BYTES = 25 << 20


def rank_and_world(group) -> Tuple[int, int]:
    """(rank, size) of this process in `group`; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _buckets(tensors):
    """Consecutive runs of `tensors` of one dtype and device, each at most
    BUCKET_BYTES (or one tensor larger than that)."""
    bucket, size = [], 0
    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or size + t.numel() * t.element_size() > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel() * t.element_size()
    if bucket:
        yield bucket


@torch.no_grad()
def replicate_(modules: Iterable[torch.nn.Module], group):
    """Every parameter and buffer of `modules` set to those of rank 0, one
    broadcast per bucket."""
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    for bucket in _buckets(tensors):
        flat = _flatten_dense_tensors(bucket)
        dist.broadcast(flat, src=0, group=group)
        for t, v in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(v)


@torch.no_grad()
def allreduce_grads_(params: Iterable[torch.Tensor], group):
    """Each `.grad` of `params` replaced by its mean over the ranks: the
    gradient of the global mean loss when each rank's loss is the mean
    over its equal share of the batch. One all-reduce per bucket of
    flattened gradients. Every rank holds the same result, so the same
    optimizer step keeps the weights bit-equal."""
    grads = [p.grad for p in params if p.grad is not None]
    world = dist.get_world_size(group)
    for bucket in _buckets(grads):
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        for g, v in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(v)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, on every rank. Its adjoint is itself, so
    the backward all-reduces the incoming gradients, through this same
    Function: a backward recorded with create_graph=True (R1's gradient of
    a gradient) differentiates again."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad.contiguous(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of `group`."""
    return _AllReduceSum.apply(x, group)


def global_rows(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """This rank's rows of `t`, drawn for the global batch: rows
    rank * b ... (rank + 1) * b - 1 of world * b."""
    n = t.shape[0]
    if n % world:
        raise ValueError(f'{n} rows do not split over {world} ranks')
    b = n // world
    return t[rank * b:(rank + 1) * b]


@torch.no_grad()
def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of `t`, concatenated in rank order (the global
    batch), on every rank: an all-reduce of zeros holding this rank's rows,
    exact in floating point (x + 0 = x)."""
    rank, world = rank_and_world(group)
    if world == 1:
        return t
    out = t.new_zeros((world * t.shape[0],) + tuple(t.shape[1:]))
    global_rows(out, rank, world).copy_(t)
    dist.all_reduce(out, group=group)
    return out


def sync_batchnorm_(module: torch.nn.Module, group):
    """Give every port BatchNorm2d of `module` the process group `group`:
    in train mode they then normalise by the statistics of the global
    batch (ops/norm.py)."""
    from ..ops.norm import BatchNorm2d   # norm.py imports this module
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
