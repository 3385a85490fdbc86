"""The process group of a data-parallel run (counterpart of
lama_tpu/parallel/multihost.py).

lama_tpu runs one process per host and `jax.distributed` joins them; the
port runs one process per card, started by torchrun
(`torchrun --nproc_per_node N -m lama_tpu_torch.train ...`), and
`torch.distributed` joins them: NCCL between cards, gloo on the CPU. With
no group every helper here answers for a single process (rank 0 of 1),
so the same code runs unlaunched.
"""
import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

LOGGER = logging.getLogger(__name__)


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v else None


def maybe_initialize_distributed(init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None,
                                 local_rank: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 device='cuda',
                                 timeout: Optional[float] = None) -> bool:
    """Initialise the default process group when the launch asks for it
    (multihost.py:20-43): from explicit arguments, else from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT).
    A launch of one process (WORLD_SIZE=1) gets a group too, so its
    collectives run as a larger world's would. Returns whether a group
    exists.

    The backend is `backend`, else NCCL for a CUDA device and gloo for the
    CPU. On CUDA the process takes card LOCAL_RANK (torch.cuda.set_device)
    before the group exists. `timeout` (seconds) bounds every collective,
    so a rank that fails does not leave the others waiting for ever."""
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else _int_env('WORLD_SIZE')
    if world_size is None:
        return False
    rank = rank if rank is not None else (_int_env('RANK') or 0)
    local_rank = (local_rank if local_rank is not None
                  else _int_env('LOCAL_RANK') or 0)
    device = torch.device(device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if device.type == 'cuda':
        torch.cuda.set_device(local_rank)
    kwargs = {}
    if timeout is not None:
        kwargs['timeout'] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            world_size=world_size, rank=rank, **kwargs)
    LOGGER.info(f'process group: rank {rank} of {world_size} ({backend}'
                + (f', card {local_rank}' if device.type == 'cuda' else '')
                + ')')
    return True


def shutdown():
    """Destroy the default group, if any (after a rank's last
    collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 gating for logs, sample grids and checkpoints (multihost.py:
    56-58; reference base.py:290-291)."""
    return process_index() == 0


def world_group():
    """The default group, or None without one."""
    return dist.group.WORLD if dist.is_initialized() else None


def barrier():
    """Every rank waits here for the others; nothing without a group."""
    if dist.is_initialized():
        dist.barrier()


def allgather_pyobj(obj):
    """One picklable object from each rank, in rank order (`[obj]` without
    a group): `dist.all_gather_object` (multihost.py:61-86). Collective:
    every rank calls it the same number of times."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_pyobj(obj):
    """Rank 0's picklable object on every rank (`obj` without a group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
