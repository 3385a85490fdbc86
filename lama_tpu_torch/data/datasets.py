"""Datasets and loaders: copies of lama_tpu/data/datasets.py, so the port
imports nothing of lama_tpu. Evaluation (the predict CLI, the evaluator and
the trainer's validation): InpaintingDataset and OurInpaintingDataset
(:232-297), their precomputed-results variants (:300-343), and
make_default_val_dataset (:603-623, kinds `default` and `our_eval`;
`online` raises). Training:
InpaintingTrainDataset (:28), collate and BatchLoader (:394-511) and
make_default_train_dataloader (:563, kind `default`; the web-shard and
segmentation kinds raise). The train dataset decodes with cv2, where the
JAX package prefers its native libjpeg decoder when built (native/); the
two give the same pixels for baseline JPEGs (tests/test_torch_host.py)."""
import glob
import logging
import os
import queue
import threading
from typing import Dict, List, Optional

import cv2
import numpy as np

from .io import ceil_modulo, load_image, pad_img_to_modulo, scale_image
from .masks import get_mask_generator
from .transforms import get_transforms

LOGGER = logging.getLogger(__name__)


class InpaintingDataset:
    """Fixed eval pairs: *mask*.png + <stem><img_suffix>
    (reference evaluation/data.py:58-83), HWC."""

    thread_safe_getitem = True  # pure IO: BatchLoader reads items in threads

    def __init__(self, datadir, img_suffix='.jpg', pad_out_to_modulo=None,
                 scale_factor=None):
        self.datadir = datadir
        self.mask_filenames = sorted(glob.glob(
            os.path.join(datadir, '**', '*mask*.png'), recursive=True))
        self.img_filenames = [f.rsplit('_mask', 1)[0] + img_suffix
                              for f in self.mask_filenames]
        self.pad_out_to_modulo = pad_out_to_modulo
        self.scale_factor = scale_factor

    def __len__(self):
        return len(self.mask_filenames)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        image = load_image(self.img_filenames[i], mode='RGB')
        mask = load_image(self.mask_filenames[i], mode='L')
        result = dict(image=image, mask=mask)
        if self.scale_factor is not None:
            result['image'] = scale_image(result['image'], self.scale_factor)
            result['mask'] = scale_image(result['mask'], self.scale_factor,
                                         interpolation=cv2.INTER_NEAREST)
        if self.pad_out_to_modulo is not None and self.pad_out_to_modulo > 1:
            result['unpad_to_size'] = np.array(result['image'].shape[:2])
            result['image'] = pad_img_to_modulo(result['image'],
                                                self.pad_out_to_modulo)
            result['mask'] = pad_img_to_modulo(result['mask'],
                                               self.pad_out_to_modulo)
        return result


class OurInpaintingDataset:
    """Alternative mask/ img/ directory layout (reference
    evaluation/data.py:85-108; the basename is split, not the full path)."""

    thread_safe_getitem = True

    def __init__(self, datadir, img_suffix='.jpg', pad_out_to_modulo=None,
                 scale_factor=None):
        self.datadir = datadir
        self.mask_filenames = sorted(glob.glob(
            os.path.join(datadir, 'mask', '**', '*mask*.png'), recursive=True))
        self.img_filenames = [
            os.path.join(datadir, 'img', os.path.basename(f).rsplit('-', 1)[0]
                         .rsplit('_', 1)[0] + '.png')
            for f in self.mask_filenames]
        self.pad_out_to_modulo = pad_out_to_modulo
        self.scale_factor = scale_factor

    def __len__(self):
        return len(self.mask_filenames)

    def __getitem__(self, i):
        result = dict(image=load_image(self.img_filenames[i], mode='RGB'),
                      mask=load_image(self.mask_filenames[i], mode='L'))
        if self.scale_factor is not None:
            result['image'] = scale_image(result['image'], self.scale_factor)
            result['mask'] = scale_image(result['mask'], self.scale_factor)
        if self.pad_out_to_modulo is not None and self.pad_out_to_modulo > 1:
            result['image'] = pad_img_to_modulo(result['image'],
                                                self.pad_out_to_modulo)
            result['mask'] = pad_img_to_modulo(result['mask'],
                                               self.pad_out_to_modulo)
        return result


class PrecomputedInpaintingResultsDataset(InpaintingDataset):
    """(image, mask, inpainted) triples for offline evaluation (reference
    evaluation/data.py:110-124): the prediction of <datadir>/<rel>/x_mask.png
    is <predictdir>/<rel>/x_mask<inpainted_suffix>, the name
    `python -m lama_tpu_torch.predict` writes."""

    def __init__(self, datadir, predictdir, inpainted_suffix='_inpainted.jpg', **kwargs):
        super().__init__(datadir, **kwargs)
        if not datadir.endswith('/'):
            datadir += '/'
        self.predictdir = predictdir
        self.pred_filenames = [
            os.path.join(predictdir, os.path.splitext(f[len(datadir):])[0] + inpainted_suffix)
            for f in self.mask_filenames]

    def __getitem__(self, i):
        result = super().__getitem__(i)
        result['inpainted'] = load_image(self.pred_filenames[i])
        if self.pad_out_to_modulo is not None and self.pad_out_to_modulo > 1:
            result['inpainted'] = pad_img_to_modulo(result['inpainted'],
                                                    self.pad_out_to_modulo)
        return result


class OurPrecomputedInpaintingResultsDataset(OurInpaintingDataset):
    """(image, mask, inpainted) triples for the mask/ img/ layout
    (reference evaluation/data.py:126-143)."""

    def __init__(self, datadir, predictdir, inpainted_suffix='png', **kwargs):
        super().__init__(datadir, **kwargs)
        if not datadir.endswith('/'):
            datadir += '/'
        self.predictdir = predictdir
        self.pred_filenames = [
            os.path.join(predictdir,
                         os.path.basename(os.path.splitext(f)[0])
                         + f'_inpainted.{inpainted_suffix}')
            for f in self.mask_filenames]

    def __getitem__(self, i):
        result = super().__getitem__(i)
        result['inpainted'] = load_image(self.pred_filenames[i])
        if self.pad_out_to_modulo is not None and self.pad_out_to_modulo > 1:
            result['inpainted'] = pad_img_to_modulo(result['inpainted'],
                                                    self.pad_out_to_modulo)
        return result


# ------------------------------------------------------------------ training

class InpaintingTrainDataset:
    """glob **/*.jpg, decode RGB, augment, generate a mask per item with an
    iteration counter for curricula (reference datasets.py:25-45)."""

    def __init__(self, indir, mask_generator, transform,
                 rng: Optional[np.random.RandomState] = None, seed: int = 0):
        self.in_files = sorted(glob.glob(os.path.join(indir, '**', '*.jpg'), recursive=True))
        self.mask_generator = mask_generator
        self.transform = transform
        self.iter_i = 0
        self.seed = int(seed)
        self.rng = rng or np.random.RandomState()

    def __len__(self):
        return len(self.in_files)

    def _load(self, path, iter_i, rng):
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        img = self.transform(image=img, rng=rng)['image']  # HWC float
        mask = self.mask_generator((img.shape[0], img.shape[1]),
                                   iter_i=iter_i, raw_image=img, rng=rng)
        return dict(image=img.astype(np.float32), mask=mask.astype(np.float32))

    def __getitem__(self, item) -> Dict[str, np.ndarray]:
        out = self._load(self.in_files[item], self.iter_i, self.rng)
        self.iter_i += 1
        return out

    def fetch(self, item, seq: int, stream_salt: int = 0) -> Dict[str, np.ndarray]:
        """Thread-safe variant used by BatchLoader: a per-call RandomState
        derived from (seed, seq, stream_salt) replaces the shared sequential
        stream of __getitem__; the curriculum counter is the sequential
        position `seq` assigned by the loader BEFORE dispatch, so results are
        deterministic for any num_workers. `stream_salt` (the loader's
        shard_id) keeps mask/augmentation streams distinct across hosts.
        (The reference's DataLoader worker processes likewise each own an RNG
        stream, datasets.py:245.)"""
        rng = np.random.RandomState(
            (self.seed + 0x9E3779B9 * (seq + 1) + 7919 * stream_salt) % (2 ** 32))
        return self._load(self.in_files[item], seq, rng)


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = items[0].keys()
    return {k: np.stack([it[k] for it in items], axis=0) for k in keys}


class BatchLoader:
    """Threaded prefetching batch loader. Shards deterministically across
    hosts (shard_id/num_shards) — the proper per-host input sharding the
    reference's DDP path skipped (SURVEY §2.2)."""

    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=3,
                 drop_last=True, shard_id=0, num_shards=1, seed=0,
                 prefetch=4, epoch=0, shard_contiguous=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = epoch
        # contiguous block shards (np.array_split) instead of strided: the
        # host-rank concatenation of shards reproduces the ORIGINAL dataset
        # order — required by validation, where per-host evaluator states are
        # merged in rank order and must align sample-for-sample with the
        # single-host full-set pass (training/trainer.py::_run_eval_loop)
        self.shard_contiguous = shard_contiguous

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        if self.shard_contiguous:
            order = np.array_split(order, self.num_shards)[self.shard_id]
        else:
            order = order[self.shard_id::self.num_shards]
        n_batches = len(order) // self.batch_size if self.drop_last \
            else ceil_modulo(len(order), self.batch_size) // self.batch_size
        return order, n_batches

    def __len__(self):
        _, n_batches = self._indices()
        return n_batches

    def __iter__(self):
        order, n_batches = self._indices()
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        # Datasets exposing `fetch(item, seq, stream_salt)` (per-item derived
        # RNG, e.g. the train dataset) always load through it so batches are
        # identical for ANY num_workers; pure-IO thread-safe datasets
        # (`thread_safe_getitem`, the eval datasets) parallelise __getitem__
        # directly. Items load across a worker thread pool (cv2 / native
        # libjpeg release the GIL) when num_workers > 1.
        use_fetch = hasattr(self.dataset, 'fetch')
        use_pool = self.num_workers > 1 and (use_fetch or getattr(
            self.dataset, 'thread_safe_getitem', False))
        # sequential item position feeds curricula; advances across epochs
        seq0 = self.epoch * len(order)

        def load(i, seq):
            return self.dataset.fetch(int(i), seq, self.shard_id) if use_fetch \
                else self.dataset[int(i)]

        def producer():
            try:
                if not use_pool:
                    seq = seq0
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        q.put(collate([load(i, seq + k)
                                       for k, i in enumerate(batch_idx)]))
                        seq += len(batch_idx)
                    return
                from collections import deque
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(self.num_workers) as pool:
                    inflight = deque()
                    seq = seq0
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        inflight.append([pool.submit(load, i, seq + k)
                                         for k, i in enumerate(batch_idx)])
                        seq += len(batch_idx)
                        if len(inflight) > 1:  # keep one batch of lookahead
                            q.put(collate([f.result() for f in inflight.popleft()]))
                    while inflight:
                        if stop.is_set():
                            return
                        q.put(collate([f.result() for f in inflight.popleft()]))
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def make_default_train_dataloader(indir, kind='default', out_size=512,
                                  mask_gen_kwargs=None, transform_variant='default',
                                  mask_generator_kind='mixed', seed=None,
                                  dataloader_kwargs=None, ddp_kwargs=None, **kwargs):
    """reference datasets.py:206-246, kind `default`."""
    if kind != 'default':
        raise NotImplementedError(f'train dataset kind {kind!r} is not ported '
                                  'yet (ROADMAP queue 1 item 10)')
    LOGGER.info(f'Make train dataloader {kind} from {indir} '
                f'(mask generator={mask_generator_kind})')
    mask_generator = get_mask_generator(kind=mask_generator_kind,
                                        kwargs=dict(mask_gen_kwargs or {}))
    if seed is not None:
        kwargs.setdefault('seed', int(seed))  # per-item fetch RNG base
    transform = get_transforms(transform_variant, out_size)
    dataset = InpaintingTrainDataset(indir=indir, mask_generator=mask_generator,
                                     transform=transform, **kwargs)
    dl_kwargs = dict(dataloader_kwargs or {})
    if ddp_kwargs is not None:
        dl_kwargs['shard_id'] = ddp_kwargs.get('rank', 0)
        dl_kwargs['num_shards'] = ddp_kwargs.get('num_replicas', 1)
    dl_kwargs.setdefault('drop_last', True)
    return BatchLoader(dataset, **dl_kwargs)


def make_default_val_dataset(indir, kind='default', out_size=512,
                             transform_variant=None, **kwargs):
    """reference datasets.py:249-289, for one input directory."""
    LOGGER.info(f'Make val dataset {kind} from {indir}')
    if kind == 'default':
        kwargs.pop('mask_generator_kind', None)
        kwargs.pop('mask_gen_kwargs', None)
        return InpaintingDataset(indir, **kwargs)
    if kind == 'our_eval':
        return OurInpaintingDataset(indir, **kwargs)
    if kind == 'online':
        raise NotImplementedError('dataset kind online (generated masks) is '
                                  'not ported yet (ROADMAP queue 1 item 10)')
    raise ValueError(f'Unknown val dataset kind {kind}')
