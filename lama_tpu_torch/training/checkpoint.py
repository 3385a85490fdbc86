"""Save and restore the train state (counterpart of
lama_tpu/training/checkpoint.py, which writes orbax pytrees).

The port writes the reference's format instead: a `torch.save`d dict with
'state_dict' ('generator.*', 'discriminator.*' and, with the EMA,
'generator_average.*'), 'optimizer_states' [G, D], 'global_step' and
'epoch', which `lama_tpu_torch.convert.load_checkpoint` (and so
`python -m lama_tpu_torch.predict`) reads and `restore` resumes from.
`CheckpointManager` keeps the best epochs by a validation metric beside
`last.ckpt`, as the JAX package's does.

In a data-parallel run (parallel/multihost.py) every rank holds the same
state, and rank 0 alone writes (`save`, `CheckpointManager.save`,
`repair_index`; the JAX package's checkpoint.py:23-40), then every rank
waits at a barrier, so none reads a checkpoint before it is whole.
"""
import json
import logging
import math
import os
from typing import Dict, List, Optional, Tuple

import torch

from ..parallel import multihost
from .state import TrainState

LOGGER = logging.getLogger(__name__)


def _write(path: str, state: TrainState, epoch: int):
    """Write the checkpoint atomically (a reader never sees half a file)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(dict(state.state_dict(), epoch=int(epoch)), tmp)
    os.replace(tmp, path)


def save(path: str, state: TrainState, epoch: int):
    """Write the checkpoint on rank 0; every rank returns once it is
    written."""
    if multihost.is_main_process():
        _write(path, state, epoch)
    multihost.barrier()


def restore(path: str, state: TrainState) -> int:
    """Load `path` into `state` (modules, optimizers, EMA, step) and return
    the epoch it was saved at. A checkpoint from this package's trainer is
    trusted input: it unpickles in full, as Lightning's do."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    state.load_state_dict(ckpt)
    return int(ckpt['epoch'])


class CheckpointManager:
    """The top-k + last policy keyed on a monitor metric (counterpart of
    lama_tpu/training/checkpoint.py:56-213; reference ModelCheckpoint(
    save_top_k=5, save_last=True, monitor='val_ssim_fid100_f1_total_mean',
    mode='max')): each epoch writes `epoch<N>.ckpt`, keeps the `save_top_k`
    best by the monitor (records in `index.json`), rewrites `last.ckpt`,
    and notes the epoch in `last_epoch.json`. A monitor value that is not
    finite or lies outside its valid range ranks strictly worst. Only rank
    0's manager touches the directory; every rank keeps the same
    records."""

    # valid ranges per monitor-name fragment, longest fragment first
    DEFAULT_MONITOR_RANGES = (
        ('ssim_fid100_f1', (0.0, 1.0)),
        ('lpips_fid100_f1', (0.0, 1.0)),
        ('ssim', (-1.0, 1.0)),
        ('lpips', (0.0, float('inf'))),
        ('fid', (0.0, float('inf'))),
    )

    @classmethod
    def monitor_range_for(cls, monitor: str) -> Optional[Tuple[float, float]]:
        for fragment, rng in cls.DEFAULT_MONITOR_RANGES:
            if fragment in (monitor or ''):
                return rng
        return None

    def __init__(self, directory: str,
                 monitor: str = 'val_ssim_fid100_f1_total_mean',
                 mode: str = 'max', save_top_k: int = 5, save_last: bool = True,
                 monitor_range: Optional[Tuple[float, float]] = None):
        self.directory = directory
        self.write = multihost.is_main_process()
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.monitor_range = (tuple(monitor_range) if monitor_range is not None
                              else self.monitor_range_for(monitor))
        self.records: List[Dict] = []
        if self.write:
            os.makedirs(directory, exist_ok=True)
        self._index_path = os.path.join(directory, 'index.json')
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self.records = json.load(f)

    def _valid_value(self, value: float) -> bool:
        if not math.isfinite(value):
            return False
        if self.monitor_range is not None:
            lo, hi = self.monitor_range
            return lo <= value <= hi
        return True

    def _ranked(self):
        return sorted(self.records, key=lambda r: r['value'],
                      reverse=(self.mode == 'max'))

    def save(self, state: TrainState, epoch: int, metrics: Dict[str, float]):
        worst = float('-inf') if self.mode == 'max' else float('inf')
        value = float(metrics.get(self.monitor, worst))
        if not self._valid_value(value):
            if self.monitor in metrics:
                LOGGER.warning(
                    f'monitor {self.monitor}={value} is non-finite or '
                    f'outside its valid range {self.monitor_range}; ranking '
                    f'epoch {epoch} strictly worst')
            value = worst
        name = f'epoch{epoch}.ckpt'
        if self.write:
            _write(os.path.join(self.directory, name), state, epoch)
            if self.save_last:
                _write(os.path.join(self.directory, 'last.ckpt'), state, epoch)
        self.records.append({'name': name, 'epoch': epoch, 'value': value})
        for r in self._ranked()[self.save_top_k:]:
            stale = os.path.join(self.directory, r['name'])
            if self.write and os.path.exists(stale):
                os.remove(stale)
            self.records.remove(r)
        if self.write:
            with open(self._index_path, 'w') as f:
                json.dump(self.records, f)
            with open(os.path.join(self.directory, 'last_epoch.json'), 'w') as f:
                json.dump({'epoch': epoch}, f)
        multihost.barrier()

    def best_path(self) -> Optional[str]:
        if not self.records:
            return None
        return os.path.join(self.directory, self._ranked()[0]['name'])

    @classmethod
    def repair_index(cls, directory: str, monitor: str = '',
                     mode: str = 'max',
                     monitor_range: Optional[Tuple[float, float]] = None
                     ) -> Dict:
        """Repair `directory`/index.json in place (lama_tpu/training/
        checkpoint.py:155-184): drop the records whose checkpoint file is
        gone, and demote the records whose value is non-finite or outside
        the monitor's valid range to strictly worst, keeping the original
        under 'invalid_value', so a value a faulty metric recorded is never
        taken as best. Returns {'kept', 'dropped', 'demoted'} by name, on
        every rank; rank 0 repairs."""
        report = None
        if multihost.is_main_process():
            report = cls._repair_index(directory, monitor, mode, monitor_range)
        return multihost.broadcast_pyobj(report)

    @classmethod
    def _repair_index(cls, directory, monitor, mode, monitor_range):
        index_path = os.path.join(directory, 'index.json')
        with open(index_path) as f:
            records = json.load(f)
        rng = (tuple(monitor_range) if monitor_range is not None
               else cls.monitor_range_for(monitor))
        lo, hi = rng if rng is not None else (float('-inf'), float('inf'))
        worst = float('-inf') if mode == 'max' else float('inf')
        kept, dropped, demoted = [], [], []
        for r in records:
            if not os.path.isfile(os.path.join(directory, str(r['name']))):
                dropped.append(r['name'])
                continue
            v = float(r['value'])
            if not (math.isfinite(v) and lo <= v <= hi):
                r = {**r, 'value': worst, 'invalid_value': v}
                demoted.append(r['name'])
            kept.append(r)
        with open(index_path, 'w') as f:
            json.dump(kept, f)
        return {'kept': [r['name'] for r in kept], 'dropped': dropped,
                'demoted': demoted}
