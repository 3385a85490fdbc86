"""Save and restore the train state (counterpart of
lama_tpu/training/checkpoint.py, which writes orbax pytrees).

The port writes the reference's format instead: a `torch.save`d dict with
'state_dict' ('generator.*', 'discriminator.*' and, with the EMA,
'generator_average.*'), 'optimizer_states' [G, D], 'global_step' and
'epoch', which `lama_tpu_torch.convert.load_checkpoint` (and so
`python -m lama_tpu_torch.predict`) reads and `restore` resumes from.
"""
import os

import torch

from .state import TrainState


def save(path: str, state: TrainState, epoch: int):
    """Write the checkpoint atomically (a reader never sees half a file)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(dict(state.state_dict(), epoch=int(epoch)), tmp)
    os.replace(tmp, path)


def restore(path: str, state: TrainState) -> int:
    """Load `path` into `state` (modules, optimizers, EMA, step) and return
    the epoch it was saved at. A checkpoint from this package's trainer is
    trusted input: it unpickles in full, as Lightning's do."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    state.load_state_dict(ckpt)
    return int(ckpt['epoch'])
