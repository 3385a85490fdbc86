"""Training CLI of the port: `python -m lama_tpu_torch.train`, the
counterpart of bin/train.py.

Usage:
  python -m lama_tpu_torch.train -cn big-lama location.data_root_dir=<data> \
      location.out_root_dir=<runs> [data.batch_size=10] [run_dir=<dir>] \
      [trainer.kwargs.max_epochs=N] [trainer.kwargs.limit_train_batches=N] \
      [losses.resnet_pl.allow_random_weights=true] [device=cuda|cpu] \
      [trainer.resume_from_checkpoint=<run_dir>/models/last.ckpt]
  torchrun --nproc_per_node N -m lama_tpu_torch.train -cn big-lama ...

Composes configs/training/<name>.yaml with its defaults and the key=value
overrides, freezes the resolved config to <run_dir>/config.yaml (which
`python -m lama_tpu_torch.predict model.path=<run_dir>` reads), builds the
InpaintingTrainer and fits. Training images are `<data>/train/**/*.jpg`.
It runs on the CUDA card unless device=cpu is asked for; without a card
device=cuda fails. The run dir is `run_dir`, else the config's hydra
template, else <out_root_dir>/<user>_<time>_<name><title>, as in bin/train.py.

Under torchrun each of the N processes drives one card (LOCAL_RANK) and
they train data-parallel on a global batch of N x data.batch_size, with
the BatchNorm statistics, gradients and logged metrics of the global batch
(training/trainer.py): NCCL between cards, gloo with device=cpu. Rank 0
resolves the run dir and tells the others, and alone writes config.yaml
and the run's files.
"""
import argparse
import datetime
import getpass
import logging
import os
import re
import sys
import traceback

from .config import compose, save_config
from .parallel import multihost
from .predict import resolve_device
from .training.trainer import InpaintingTrainer

LOGGER = logging.getLogger(__name__)
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs', 'training')


def resolve_run_dir(config, config_name: str) -> str:
    """bin/train.py's run-dir rule (train.py:52-73)."""
    run_dir = config.get('run_dir')
    if not run_dir:
        template = config.select('hydra.run.dir')
        if template:
            run_dir = re.sub(
                r'\$\{now:([^}]*)\}',
                lambda m: datetime.datetime.now().strftime(m.group(1)), template)
            run_dir = (run_dir.replace('${hydra:job.name}', 'train')
                       .replace('${hydra:job.config_name}', config_name))
    if not run_dir:
        out_root = config.select('location.out_root_dir') or os.getcwd()
        stamp = datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')
        title = config.get('run_title', '') or ''
        run_dir = os.path.join(out_root,
                               f'{getpass.getuser()}_{stamp}_{config_name}{title}')
    return run_dir


def main(config_name, overrides):
    """Compose, freeze the config, fit; returns the trainer."""
    logging.basicConfig(level=logging.INFO, force=True)
    config = compose(CONFIG_DIR, config_name, overrides)
    device = resolve_device(str(config.get('device', 'cuda')))
    multihost.maybe_initialize_distributed(device=device)
    # one run dir for every rank: its template holds the time
    run_dir = multihost.broadcast_pyobj(
        resolve_run_dir(config, config_name) if multihost.is_main_process()
        else None)
    if multihost.is_main_process():
        os.makedirs(run_dir, exist_ok=True)
        save_config(config, os.path.join(run_dir, 'config.yaml'))
        LOGGER.info(f'Run dir: {run_dir}')
    trainer = InpaintingTrainer(config, run_dir, device=device)
    resume = config.select('trainer.resume_from_checkpoint')
    trainer.fit(resume_from=resume if isinstance(resume, str) else None)
    return trainer


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('-cn', '--config-name', required=True,
                        help='preset under configs/training, e.g. big-lama')
    parser.add_argument('overrides', nargs='*', help='key=value overrides')
    args = parser.parse_args()
    try:
        main(args.config_name, args.overrides)
    except KeyboardInterrupt:
        LOGGER.warning('Interrupted by user')
        sys.exit(1)
    except Exception as ex:
        LOGGER.critical(f'Training failed due to {ex}:\n{traceback.format_exc()}')
        sys.exit(1)
    multihost.shutdown()
