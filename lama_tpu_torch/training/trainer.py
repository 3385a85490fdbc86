"""Training orchestration (counterpart of lama_tpu/training/trainer.py).

Builds the generator, discriminator, losses, optimizers and visualizer from
the config tree, as the JAX trainer does (trainer.py:54-287), and `fit`
runs epochs of `InpaintingTrainStep` on one device: `limit_train_batches`
per epoch, `max_epochs`, scalars logged every `log_every_n_steps` (to the
run log and `<run_dir>/metrics.jsonl`), the NaN screen
(`terminate_on_nan`), sample grids every `visualize_each_iters`. After each
epoch it validates, as the JAX trainer does (trainer.py:541-605): the val,
visual_test and extra_val datasets that hold images each run the
eval-mode generator (so the CUDA kernels) and the evaluator of the
`evaluator` config (SSIM, LPIPS, FID and the integral metric on the same
device), logged as `<prefix>_<metric>_<bin>_<stat>` (val, test,
extra_val_<title>); then `training/checkpoint.py::CheckpointManager`
writes `<run_dir>/models/epoch<N>.ckpt`, keeps the `save_top_k` best by
`trainer.checkpoint_kwargs.monitor` (val_ssim_fid100_f1_total_mean) and
rewrites `last.ckpt`, from which `fit(resume_from)` continues.

The options of lama_tpu's trainer (trainer.py:73-181, :254-284): the VGG19
perceptual loss (weights from $LAMA_VGG19_WEIGHTS, else seeded random
ones), the distance-weighted masks, fake fakes, multiscale input noise,
lazy R1 (`losses.adversarial.r1_every`); on the host, the rescale ramp and
the constant-area crop (`training_model.rescale_scheduler_kwargs`,
`const_area_crop_kwargs`; sizes from a shared stream, positions from a
per-host one, seeded as lama_tpu seeds them), the uint8 input wire
(quantised on the host, /255 on the device) and `steps_per_dispatch` K:
K batches stacked on the host and moved to the device in one copy, then K
steps, each as a single step would run it (lama_tpu's refusals kept: no
curricula, limit_train_batches a multiple of K). The web-shard train data
cycles its shards to `limit_train_batches` batches an epoch.

Data parallel (lama_tpu's ('data',) mesh, trainer.py:192-203 there): one
process per card under torchrun, joined by the default process group
(parallel/multihost.py). Each of W ranks loads its own shard of the train
data at `data.batch_size` images (ddp_kwargs; web shards round-robin, and
then `limit_train_batches` is required), and the step computes lama_tpu's
mesh step on the global batch of W x `data.batch_size`: G and D start
from rank 0's weights, their BatchNorms take global statistics and their
gradients are averaged before the clip (parallel/data_parallel.py). The
crop position stream is seeded per rank. On a logging step the metrics
are averaged over the ranks before the NaN screen, so every rank raises
together. Validation runs each rank's contiguous shard and merges the
score states in rank order (`allgather_pyobj`), so every rank computes
the same metrics and keeps the same checkpoint records. Rank 0 alone
writes the run dir: metrics.jsonl, the step logs, sample grids and
checkpoints. `trainer.kwargs.gpus` / `devices` above 1 must match the
launched world: one process drives one card.
"""
import json
import logging
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config.node import ConfigNode
from ..data.datasets import (BatchLoader, IterableBatchLoader,
                             make_constant_area_crop_params,
                             make_default_train_dataloader,
                             make_default_val_dataset)
from ..evaluation import make_evaluator
from ..evaluation.utils import results_to_tsv
from ..losses.adversarial import make_discrim_loss
from ..losses.distance_weighting import make_mask_distance_weighter
from ..models import make_discriminator, make_generator
from ..models.fake_fakes import FakeFakesGenerator
from ..ops.resize import interpolate
from ..parallel import multihost
from ..parallel.data_parallel import replicate_, sync_batchnorm_
from ..utils.ramps import get_ramp
from . import checkpoint
from .state import TrainState, make_optimizer
from .step import EMAConfig, InpaintingTrainStep, LossConfig
from .visualizers import make_visualizer

LOGGER = logging.getLogger(__name__)
_DTYPES = {'bf16': torch.bfloat16, '16': torch.bfloat16, '32': torch.float32,
           'fp32': torch.float32}


class InpaintingTrainer:
    def __init__(self, config: ConfigNode, run_dir: str, device='cuda',
                 kernels: str = 'cuda'):
        self.config = config
        self.run_dir = run_dir
        self.device = torch.device(device)
        # the launched world (parallel/multihost.py; rank 0 of 1 unlaunched)
        self.group = multihost.world_group()
        self.rank = multihost.process_index()
        self.world = multihost.process_count()
        self.is_main = self.rank == 0
        for path in ('trainer.kwargs.devices', 'trainer.kwargs.gpus'):
            n = int(config.select(path, 1) or 1)
            if n > 1 and n != self.world:
                raise NotImplementedError(
                    f'{path}={n} in a world of {self.world} process(es): one '
                    f'process drives one card; launch {n}: torchrun '
                    f'--nproc_per_node {n} -m lama_tpu_torch.train ...')
        if self.is_main:
            os.makedirs(run_dir, exist_ok=True)
        tm = config.get('training_model', ConfigNode())

        precision = str(config.select('trainer.kwargs.precision', 'bf16'))
        if precision not in _DTYPES:
            raise ValueError(f'trainer.kwargs.precision={precision!r}: '
                             'expected bf16 or 32')
        self.dtype = _DTYPES[precision]
        if self.dtype == torch.float32:   # TF32 keeps ~3 digits: off
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        seed = int(config.get('seed', 0) or 0)
        torch.manual_seed(seed)   # the random initialisation

        # ---- models
        gen_kwargs = dict(config.generator)
        self.generator = make_generator(gen_kwargs.pop('kind'), dtype=self.dtype,
                                        kernels=kernels, **gen_kwargs)
        disc_kwargs = dict(config.discriminator)
        self.discriminator = make_discriminator(disc_kwargs.pop('kind'),
                                                dtype=self.dtype,
                                                kernels=kernels, **disc_kwargs)

        # ---- losses
        adv_kwargs = dict(config.losses.adversarial)
        adv_kind = adv_kwargs.pop('kind')
        r1_every = int(adv_kwargs.pop('r1_every', 1) or 1)
        adversarial = make_discrim_loss(adv_kind, **adv_kwargs)
        perceptual_fn = None
        resnet_pl_weight = float(config.select('losses.resnet_pl.weight', 0) or 0)
        if resnet_pl_weight > 0:
            from ..losses.perceptual import ResNetPL
            arch = config.select('losses.resnet_pl.arch_encoder',
                                 'resnet50dilated')
            segmentation = bool(config.select('losses.resnet_pl.segmentation',
                                              True))
            wp = config.select('losses.resnet_pl.weights_path') or None
            if isinstance(wp, str) and os.path.isdir(wp):
                # the ADE20k checkpoint layout under TORCH_HOME
                # (trainer.py:90-96 of the JAX package)
                wp = (os.path.join(wp, 'ade20k',
                                   'ade20k-resnet50dilated-ppm_deepsup',
                                   'encoder_epoch_20.pth') if segmentation
                      else os.path.join(wp, f'{arch}-imagenet.pth'))
            perceptual_fn = ResNetPL(
                weights_path=wp, arch_encoder=arch, dtype=self.dtype,
                allow_random_weights=bool(config.select(
                    'losses.resnet_pl.allow_random_weights', False)))
        vgg_perceptual_fn = None
        if float(config.select('losses.perceptual.weight', 0) or 0) > 0:
            from ..losses.perceptual import VGG19PerceptualLoss
            vgg_perceptual_fn = VGG19PerceptualLoss(
                weights_path=os.environ.get('LAMA_VGG19_WEIGHTS'),
                dtype=self.dtype)
        loss_config = LossConfig(
            l1_weight_known=float(config.select('losses.l1.weight_known', 10)),
            l1_weight_missing=float(config.select('losses.l1.weight_missing', 0)),
            feature_matching_weight=float(
                config.select('losses.feature_matching.weight', 0)),
            feature_matching_pass_mask=bool(
                config.select('losses.feature_matching.pass_mask', False)),
            resnet_pl_weight=resnet_pl_weight,
            perceptual_weight=float(config.select('losses.perceptual.weight', 0)))
        ema = EMAConfig(
            enabled=bool(tm.get('average_generator', False)),
            beta=float(tm.get('generator_avg_beta', 0.999)),
            start_step=int(tm.get('average_generator_start_step', 30000)),
            period=int(tm.get('average_generator_period', 10)))
        self.visualize_each_iters = int(tm.get('visualize_each_iters', 1000))
        self.store_discr_outputs_for_vis = bool(
            tm.get('store_discr_outputs_for_vis', False))
        dw_kwargs = tm.get('distance_weighter_kwargs', None)
        distance_weighter = (make_mask_distance_weighter(**dict(dw_kwargs))
                             if dw_kwargs else None)
        fake_fakes_proba = float(tm.get('fake_fakes_proba', 0) or 0)
        fake_fakes_gen = (FakeFakesGenerator(**dict(
            tm.get('fake_fakes_generator_kwargs', None) or {}))
            if fake_fakes_proba > 1e-3 else None)
        clip = config.select('trainer.kwargs.gradient_clip_val', None)
        self.step_fn = InpaintingTrainStep(
            adversarial, loss_config=loss_config, ema=ema,
            perceptual_fn=perceptual_fn, vgg_perceptual_fn=vgg_perceptual_fn,
            concat_mask=bool(tm.get('concat_mask', True)),
            image_to_discriminator=str(tm.get('image_to_discriminator',
                                              'predicted_image')),
            clip_grad_norm=float(clip) if clip else None,
            distance_weighter=distance_weighter,
            distance_weighted_mask_for_discr=bool(
                tm.get('distance_weighted_mask_for_discr', False)),
            fake_fakes_proba=fake_fakes_proba, fake_fakes_gen=fake_fakes_gen,
            add_noise_kwargs=tm.get('add_noise_kwargs', None),
            noise_fill_hole=bool(tm.get('noise_fill_hole', False)),
            r1_every=r1_every, seed=seed, group=self.group)

        # ---- host curricula (trainer.py:137-154 of the JAX package): the
        # crop size from a stream shared by every rank, its position from
        # a per-rank one
        rs_kwargs = tm.get('rescale_scheduler_kwargs', None)
        self.rescale_size_getter = get_ramp(**dict(rs_kwargs)) if rs_kwargs else None
        cac = tm.get('const_area_crop_kwargs', None)
        self.const_area_crop_kwargs = dict(cac) if cac else None
        self._shared_rng = np.random.RandomState(seed)
        self._host_rng = np.random.RandomState(seed + 7919 * self.rank)

        # ---- state: modules on the device, optimizers over their parameters
        self.generator.to(self.device)
        self.discriminator.to(self.device)
        for module in (perceptual_fn, vgg_perceptual_fn, distance_weighter):
            if isinstance(module, torch.nn.Module):
                module.to(self.device)
        if self.group is not None:
            # put_replicated; global BN statistics for the two players only
            # (the loss nets stay in eval mode)
            for module in (self.generator, self.discriminator):
                sync_batchnorm_(module, self.group)
            replicate_((self.generator, self.discriminator), self.group)

        def build_opt(params, opt_cfg):
            kw = dict(opt_cfg)
            return make_optimizer(params, kw.pop('kind', 'adam'), **kw)

        self.state = TrainState(
            self.generator, self.discriminator,
            build_opt(self.generator.parameters(), config.optimizers.generator),
            build_opt(self.discriminator.parameters(),
                      config.optimizers.discriminator),
            ema=([p.detach().clone() for p in self.generator.parameters()]
                 if ema.enabled else None))

        # ---- visualizer, logging, loop limits
        vis_kwargs = dict(config.get('visualizer', {}) or {'kind': 'noop'})
        vis_kind = vis_kwargs.pop('kind', 'noop')
        if not self.is_main:   # rank 0 alone draws the sample grids
            vis_kind, vis_kwargs = 'noop', {}
        if vis_kind == 'directory':
            vis_kwargs['outdir'] = os.path.join(run_dir,
                                                vis_kwargs.get('outdir', 'samples'))
        self.visualizer = make_visualizer(vis_kind, **vis_kwargs)
        self.log_every_n_steps = int(
            config.select('trainer.kwargs.log_every_n_steps', 250))
        self.max_epochs = int(config.select('trainer.kwargs.max_epochs', 1))
        self.limit_train_batches = config.select('trainer.kwargs.limit_train_batches')
        self.terminate_on_nan = bool(
            config.select('trainer.kwargs.terminate_on_nan', False))
        self.limit_val_batches = config.select('trainer.kwargs.limit_val_batches')
        self.metrics_path = os.path.join(run_dir, 'metrics.jsonl')
        # K steps per loop over K stacked batches (trainer.py:254-284 of
        # the JAX package, with its refusals)
        self.steps_per_dispatch = int(
            config.select('trainer.kwargs.steps_per_dispatch', 1) or 1)
        if self.steps_per_dispatch > 1:
            if (self.rescale_size_getter is not None
                    or self.const_area_crop_kwargs is not None):
                raise ValueError(
                    'steps_per_dispatch > 1 requires static batch shapes: '
                    'disable training_model.rescale_scheduler_kwargs / '
                    'const_area_crop_kwargs')
            if (self.limit_train_batches and int(self.limit_train_batches)
                    % self.steps_per_dispatch):
                raise ValueError(
                    f'trainer.kwargs.limit_train_batches='
                    f'{self.limit_train_batches} must be a multiple of '
                    f'steps_per_dispatch={self.steps_per_dispatch}')
        # the host -> device wire of the train batch: fp32, or uint8 (4x
        # fewer bytes; exact for 8-bit images and binary masks)
        self.input_transfer_dtype = str(
            config.select('trainer.kwargs.input_transfer_dtype', 'fp32'))
        if self.input_transfer_dtype not in ('fp32', 'uint8'):
            raise ValueError(
                f'trainer.kwargs.input_transfer_dtype='
                f'{self.input_transfer_dtype!r}: expected fp32 or uint8')

        # ---- evaluators (val, visual_test, extra_val), built at first use
        self.evaluator_kwargs = dict(config.get('evaluator', {}) or {})
        self.evaluator_kwargs.pop('kind', None)
        self.evaluator_kwargs.pop('inpainted_key', None)
        self.evaluators = {}
        self.extra_val_titles = list(config.select('data.extra_val', None) or {})

        # ---- checkpoints: top-k by the monitor, and last.ckpt
        ckpt_kwargs = dict(config.select('trainer.checkpoint_kwargs', {}) or {})
        self.checkpoints = checkpoint.CheckpointManager(
            os.path.join(run_dir, 'models'),
            monitor=ckpt_kwargs.get('monitor', 'val_ssim_fid100_f1_total_mean'),
            mode=ckpt_kwargs.get('mode', 'max'),
            save_top_k=int(ckpt_kwargs.get('save_top_k', 5)),
            save_last=bool(ckpt_kwargs.get('save_last', True)),
            monitor_range=ckpt_kwargs.get('monitor_range', None))

    @property
    def global_step(self) -> int:
        return self.state.step

    # ------------------------------------------------------------------ data
    def train_dataloader(self):
        kwargs = dict(self.config.data.train)
        kwargs['dataloader_kwargs'] = dict(kwargs.get('dataloader_kwargs', {}))
        kwargs['dataloader_kwargs'].setdefault('batch_size',
                                               self.config.data.batch_size)
        seed = int(self.config.get('seed', 0) or 0)
        kwargs['dataloader_kwargs'].setdefault('seed', seed)
        kwargs.setdefault('seed', seed)
        # each rank its own shard (trainer.py:298-301 of the JAX package)
        kwargs['ddp_kwargs'] = dict(rank=self.rank, num_replicas=self.world)
        loader = make_default_train_dataloader(**kwargs)
        if isinstance(loader, IterableBatchLoader):
            # webdataset's .repeat(): a fixed number of batches an epoch,
            # which ranks whose shards hold unequal counts need, or one
            # would wait for ever in the step's collectives
            if self.limit_train_batches:
                loader.epoch_batches = int(self.limit_train_batches)
            elif self.world > 1:
                raise ValueError(
                    'data-parallel web-shard training needs '
                    'trainer.kwargs.limit_train_batches to fix the epoch '
                    'length (the ranks\' shards may hold unequal sample '
                    'counts)')
        return loader

    def prepare_train_batch(self, batch):
        """The rescale ramp and the constant-area crop of the batch, on the
        host, for the step about to run (trainer.py:396-422 of the JAX
        package): cv2 bilinear (images) and nearest (masks) to the ramp's
        size, then one crop for the whole batch."""
        if self.rescale_size_getter is None and self.const_area_crop_kwargs is None:
            return batch
        import cv2
        image, mask = np.asarray(batch['image']), np.asarray(batch['mask'])
        if self.rescale_size_getter is not None:
            cur = int(self.rescale_size_getter(self.global_step))
            image = np.stack([cv2.resize(im, (cur, cur),
                                         interpolation=cv2.INTER_LINEAR)
                              for im in image])
            mask = np.stack([cv2.resize(m[..., 0], (cur, cur),
                                        interpolation=cv2.INTER_NEAREST)[..., None]
                             for m in mask])
        if self.const_area_crop_kwargs is not None:
            _, _, h, w = make_constant_area_crop_params(
                img_height=image.shape[1], img_width=image.shape[2],
                rng=self._shared_rng, **self.const_area_crop_kwargs)
            y = self._host_rng.randint(0, image.shape[1] - h + 1)
            x = self._host_rng.randint(0, image.shape[2] - w + 1)
            image, mask = image[:, y:y + h, x:x + w], mask[:, y:y + h, x:x + w]
        return dict(batch, image=image, mask=mask)

    def to_wire(self, batch):
        """The host side of the input wire: (image, mask) NHWC arrays,
        float32, or uint8 quantised by np.rint(x * 255), which inverts the
        loader's /255 for 8-bit values (trainer.py:424-433 of the JAX
        package)."""
        if self.input_transfer_dtype == 'uint8':
            return tuple(np.rint(np.asarray(batch[k]) * 255.0).astype(np.uint8)
                         for k in ('image', 'mask'))
        return tuple(np.ascontiguousarray(batch[k], np.float32)
                     for k in ('image', 'mask'))

    def to_device(self, wire):
        """Wire arrays, (..., H, W, C) -> float32 tensors (..., C, H, W)
        on the device (channels-last in memory, as the loader's arrays
        are); a uint8 wire is divided by 255 there."""
        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, non_blocking=True)
            t = t.float() / 255.0 if t.dtype == torch.uint8 else t
            return t.movedim(-1, -3)
        return tuple(put(a) for a in wire)

    # ------------------------------------------------------------------- fit
    def fit(self, resume_from: Optional[str] = None):
        start_epoch = 0
        if resume_from:
            LOGGER.info(f'Resuming from {resume_from}')
            start_epoch = checkpoint.restore(resume_from, self.state) + 1
        loader = self.train_dataloader()
        k = self.steps_per_dispatch
        for epoch in range(start_epoch, self.max_epochs):
            loader.set_epoch(epoch)
            t_epoch = time.time()
            chunk = []
            for batch_i, batch in enumerate(loader):
                if (self.limit_train_batches
                        and batch_i >= int(self.limit_train_batches)):
                    break
                chunk.append((batch_i, self.prepare_train_batch(batch)))
                if len(chunk) == k:
                    self._run_steps(epoch, chunk)
                    chunk = []
            if chunk:
                LOGGER.info(f'epoch {epoch}: dropped {len(chunk)} trailing '
                            f'batch(es) < steps_per_dispatch={k}')
            LOGGER.info(f'epoch {epoch} train done in '
                        f'{time.time() - t_epoch:.1f}s')
            t_val = time.time()
            val_metrics = self.validate(epoch)
            LOGGER.info(f'epoch {epoch} validation done in '
                        f'{time.time() - t_val:.1f}s')
            if val_metrics and self.is_main:
                with open(self.metrics_path, 'a') as f:
                    f.write(json.dumps(dict(step=self.global_step, epoch=epoch,
                                            **val_metrics)) + '\n')
            self.checkpoints.save(self.state, epoch, val_metrics)
        return self.state

    def _run_steps(self, epoch, chunk):
        """The steps of `chunk` ((batch_i, batch) pairs): their wires
        stacked on the host and moved in one copy, then one step each."""
        wires = [self.to_wire(batch) for _, batch in chunk]
        if len(wires) == 1:
            images, masks = self.to_device(wires[0])
            images, masks = images[None], masks[None]
        else:
            images, masks = self.to_device(
                tuple(np.stack(parts) for parts in zip(*wires)))
        for (batch_i, batch), image, mask in zip(chunk, images, masks):
            step = self.global_step
            metrics = self.step_fn(self.state, image, mask)
            self._bookkeeping(epoch, step, batch_i, batch, metrics)

    def _bookkeeping(self, epoch, step, batch_i, batch, metrics):
        """Logging, the NaN screen and sample grids for the step just run
        (number `step`); metrics are read back only on logging steps, as
        their mean over the ranks."""
        if step % self.log_every_n_steps == 0:
            host = self.global_metrics(metrics)
            if self.is_main:
                with open(self.metrics_path, 'a') as f:
                    f.write(json.dumps(dict(step=step, epoch=epoch, **host))
                            + '\n')
                LOGGER.info(f'epoch {epoch} step {step}: ' + ' '.join(
                    f'{k}={v:.4f}' for k, v in list(host.items())[:6]))
            if self.terminate_on_nan and not all(
                    math.isfinite(v) for v in host.values()):
                raise FloatingPointError(
                    f'non-finite training metrics at step {step}: {host}')
        if (self.visualize_each_iters and self.is_main
                and step % self.visualize_each_iters == 0):
            self._visualize(epoch, batch_i, batch, suffix='_train')

    def global_metrics(self, metrics) -> Dict[str, float]:
        """The step's metrics (0-d tensors, each this rank's mean) as
        floats, averaged over the ranks (one all-reduce): the global
        batch's means, which lama_tpu's mesh step returns."""
        if self.group is None:
            return {k: float(v) for k, v in metrics.items()}
        keys = list(metrics)
        values = torch.stack([metrics[k].detach().float() for k in keys])
        torch.distributed.all_reduce(values, group=self.group)
        values = (values / self.world).tolist()
        return dict(zip(keys, values))

    # ------------------------------------------------------------- validation
    def val_dataloader(self, key='val'):
        """The loader of data.val, data.visual_test or an extra_val title
        (trainer.py:318-338 of the JAX package): this rank's contiguous
        shard, so the shards in rank order are the dataset's order."""
        if key in ('val', 'visual_test'):
            kwargs = dict(self.config.data[key])
        else:
            kwargs = dict(self.config.data.extra_val[key])
        dl_kwargs = dict(kwargs.pop('dataloader_kwargs', {}) or {})
        dl_kwargs.setdefault('batch_size',
                             self.config.data.get('val_batch_size', 1))
        dl_kwargs.pop('shuffle', None)
        dl_kwargs.pop('num_workers', None)
        kwargs.setdefault('kind', 'default')
        dataset = make_default_val_dataset(**kwargs)
        return BatchLoader(dataset, shuffle=False, drop_last=False,
                           shard_id=self.rank, num_shards=self.world,
                           shard_contiguous=True, **dl_kwargs)

    def evaluator(self, key):
        if key not in self.evaluators:
            self.evaluators[key] = make_evaluator(device=self.device,
                                                  **self.evaluator_kwargs)
        return self.evaluators[key]

    def validate(self, epoch: int) -> Dict[str, float]:
        """The val, visual_test and extra_val loops, each giving
        <prefix>_<metric>_<bin>_<stat> keys (reference trainers/base.py:
        124-161, 180-222); a dataset with no images is skipped."""
        out = self._run_eval_loop(epoch, 'val', prefix='val')
        if self.config.select('data.visual_test'):
            out.update(self._run_eval_loop(epoch, 'visual_test', prefix='test',
                                           visualize_all=True))
        for title in self.extra_val_titles:
            out.update(self._run_eval_loop(epoch, title,
                                           prefix=f'extra_val_{title}'))
        return out

    def _run_eval_loop(self, epoch: int, data_key: str, prefix: str,
                       visualize_all: bool = False) -> Dict[str, float]:
        loader = self.val_dataloader(data_key)
        if not len(loader.dataset):
            LOGGER.info(f'epoch {epoch}: no {data_key} data; skipping')
            return {}
        evaluator = self.evaluator(data_key)
        states = []
        for batch_i, batch in enumerate(loader):
            if self.limit_val_batches and batch_i >= int(self.limit_val_batches):
                break
            image = np.asarray(batch['image'], np.float32)
            mask = (batch['mask'] > 0).astype(np.float32)
            pred, inpainted = self._eval_forward(image, mask)
            ev_batch = {'image': image, 'mask': mask,
                        'predicted_image': pred, 'inpainted': inpainted}
            states.append(evaluator.process_batch(ev_batch))
            if (batch_i == 0 or visualize_all) and self.is_main:
                self._visualize(epoch, batch_i, ev_batch, suffix=f'_{prefix}')
        if self.group is not None:
            # every rank's states (and mask-area bins), in rank order, on
            # every rank (trainer.py:581-592 of the JAX package); every rank
            # calls this, also with no batch of its own
            merged = multihost.allgather_pyobj((list(evaluator.groups), states))
            evaluator.groups = [g for groups, _ in merged for g in groups]
            states = [st for _, rank_states in merged for st in rank_states]
        if not states:
            return {}
        results = evaluator.evaluation_end(states=states)
        out = {}
        for (name, group), values in results.items():
            group = group.replace('%', '').replace('-', '_')
            for stat, val in values.items():
                out[f'{prefix}_{name}_{group}_{stat}'] = float(val)
        if self.is_main:
            LOGGER.info(f'epoch {epoch} {data_key}: ' + ' '.join(
                f'{k}={v:.4f}' for k, v in out.items() if 'total' in k))
            LOGGER.info(f'{data_key} metrics after epoch #{epoch}:\n'
                        + results_to_tsv(results))
        return out

    # ---------------------------------------------------------------- helpers
    @torch.no_grad()
    def _eval_forward(self, image, mask):
        """The eval-mode generator on an NHWC numpy batch: (predicted,
        inpainted), NHWC float32 numpy; the generator is put back in train
        mode after."""
        gen = self.state.generator
        gen.eval()
        try:
            img, msk = (torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device).permute(0, 3, 1, 2) for a in (image, mask))
            pred = gen(self.step_fn.generator_input(
                img, msk, self.step_fn.eval_noise(img))).float()
            inpainted = msk * pred + (1 - msk) * img
        finally:
            gen.train()
        return tuple(t.permute(0, 2, 3, 1).cpu().numpy()
                     for t in (pred, inpainted))

    @torch.no_grad()
    def _visualize(self, epoch, batch_i, batch, suffix=''):
        """Sample grid of the eval-mode generator (its outputs computed here
        unless the batch holds them) and, if configured, the
        discriminator's score maps; modules put back in train mode after."""
        vis = {k: np.asarray(v, np.float32) for k, v in batch.items()
               if k in ('image', 'mask', 'predicted_image', 'inpainted')}
        vis['mask'] = (vis['mask'] > 0).astype(np.float32)
        if 'inpainted' not in vis:
            vis['predicted_image'], vis['inpainted'] = self._eval_forward(
                vis['image'], vis['mask'])
        if self.store_discr_outputs_for_vis:
            disc = self.state.discriminator
            disc.eval()
            try:
                image, pred = (torch.from_numpy(vis[k]).to(self.device).permute(
                    0, 3, 1, 2) for k in ('image', 'predicted_image'))
                size = tuple(image.shape[2:])
                real, fake = (interpolate(disc(x)[0].float(), size=size,
                                          mode='nearest').permute(0, 2, 3, 1)
                              .cpu().numpy() for x in (image, pred))
            finally:
                disc.train()
            vis.update(discr_output_real=real, discr_output_fake=fake,
                       discr_output_diff=real - fake)
        self.visualizer(epoch, batch_i, vis, suffix=suffix)
