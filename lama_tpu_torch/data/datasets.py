"""Datasets and loaders: copies of lama_tpu/data/datasets.py, so the port
imports nothing of lama_tpu. Evaluation (the predict CLI, the evaluator and
the trainer's validation): InpaintingDataset and OurInpaintingDataset
(:232-297), their precomputed-results variants (:300-343),
InpaintingEvalOnlineDataset (:346-376, masks generated on load),
ConcatDataset (:378-392, val over a list of directories) and
make_default_val_dataset (:603-623, kinds `default`, `our_eval` and
`online`). Training: InpaintingTrainDataset (:28), expand_shards and
InpaintingTrainWebDataset (:78-190, stdlib tar shards with a shuffle
buffer), ImgSegmentationDataset (:191-230, one-hot ADE20k segmentation),
collate, BatchLoader and IterableBatchLoader (:394-560),
make_default_train_dataloader (:563, kinds `default`, `default_web` and
`img_with_segm`) and make_constant_area_crop_params (:633-648). The train
datasets decode with cv2, where the JAX package prefers its native libjpeg
decoder when built (native/); the two give the same pixels for baseline
JPEGs (tests/test_torch_host.py)."""
import glob
import itertools
import logging
import os
import queue
import re
import tarfile
import threading
from typing import Dict, List, Optional, Sequence

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


class InpaintingEvalOnlineDataset:
    """Images + masks generated on load (reference evaluation/data.py:145-168)."""

    def __init__(self, indir, mask_generator, img_suffix='.jpg',
                 pad_out_to_modulo=None, scale_factor=None,
                 rng: Optional[np.random.RandomState] = None, **kwargs):
        self.indir = indir
        self.mask_generator = mask_generator
        self.img_filenames = sorted(glob.glob(
            os.path.join(indir, '**', f'*{img_suffix}'), recursive=True))
        self.pad_out_to_modulo = pad_out_to_modulo
        self.scale_factor = scale_factor
        self.rng = rng or np.random.RandomState()

    def __len__(self):
        return len(self.img_filenames)

    def __getitem__(self, i):
        img, raw_image = load_image(self.img_filenames[i], mode='RGB',
                                    return_orig=True)
        mask = self.mask_generator((img.shape[0], img.shape[1]),
                                   raw_image=raw_image, rng=self.rng)
        result = dict(image=img, mask=mask.astype(np.float32))
        if self.scale_factor is not None:
            result['image'] = scale_image(result['image'], self.scale_factor)
            result['mask'] = scale_image(result['mask'], self.scale_factor,
                                         interpolation=cv2.INTER_NEAREST)
        if self.pad_out_to_modulo is not None and self.pad_out_to_modulo > 1:
            result['image'] = pad_img_to_modulo(result['image'],
                                                self.pad_out_to_modulo)
            result['mask'] = pad_img_to_modulo(result['mask'],
                                               self.pad_out_to_modulo)
        return result


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1]) if len(self.datasets) else 0

    def __getitem__(self, i):
        ds_idx = int(np.searchsorted(self.offsets, i, side='right'))
        prev = 0 if ds_idx == 0 else int(self.offsets[ds_idx - 1])
        return self.datasets[ds_idx][i - prev]


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


def expand_shards(pattern: str) -> List[str]:
    """A webdataset shard pattern as a sorted file list: `{00000..00039}`
    brace ranges (the syntax the reference's `webdataset.Dataset(indir)`
    takes, reference datasets.py:50) and glob wildcards; a literal path
    passes through."""
    def _expand_braces(p: str) -> List[str]:
        m = re.search(r'\{(\d+)\.\.(\d+)\}', p)
        if m is None:
            return [p]
        lo, hi = m.group(1), m.group(2)
        out = []
        for i in range(int(lo), int(hi) + 1):
            out.extend(_expand_braces(p[:m.start()] + str(i).zfill(len(lo))
                                      + p[m.end():]))
        return out

    files: List[str] = []
    for candidate in _expand_braces(pattern):
        if any(c in candidate for c in '*?['):
            files.extend(glob.glob(candidate))
        else:
            files.append(candidate)
    return sorted(files)


class InpaintingTrainWebDataset:
    """Iterable training dataset over webdataset-style tar shards
    (reference datasets.py:48-61, kind='default_web') on the stdlib's
    tarfile with a shuffle buffer. The shard list is split round-robin
    across hosts (`shard_id::num_shards`). Epochs are deterministic given
    (seed, epoch, cycle): `set_epoch` reshuffles the shard order and
    reseeds the sample stream; `set_cycle` numbers the repeat passes of
    one epoch (IterableBatchLoader)."""

    def __init__(self, indir, mask_generator, transform, shuffle_buffer=200,
                 shard_id=0, num_shards=1, seed: Optional[int] = None,
                 rng: Optional[np.random.RandomState] = None):
        all_shards = expand_shards(indir)
        self.shards = all_shards[shard_id::num_shards]
        if not self.shards:
            raise ValueError(
                f'Web dataset {indir!r}: {len(all_shards)} shard(s) cannot '
                f'feed host {shard_id} of {num_shards}: need at least one '
                'shard per host')
        self.mask_generator = mask_generator
        self.transform = transform
        self.shuffle_buffer = shuffle_buffer
        self.shard_id = int(shard_id)
        self.seed = seed
        self.epoch = 0
        self.cycle = 0
        self._rng = rng   # an explicit rng overrides the (seed, epoch) one

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def set_cycle(self, cycle: int):
        self.cycle = int(cycle)

    def _epoch_rng(self) -> np.random.RandomState:
        if self._rng is not None:
            return self._rng
        base = 0 if self.seed is None else int(self.seed)
        return np.random.RandomState(
            (base + 0x9E3779B9 * (self.epoch + 1) + 7919 * self.shard_id
             + 0x85EBCA6B * self.cycle) % (2 ** 32))

    def _iter_images(self, shards):
        for shard in shards:
            with tarfile.open(shard) as tf:
                for member in tf:
                    if not member.isfile() or not member.name.lower().endswith(
                            ('.jpg', '.jpeg', '.png')):
                        continue
                    data = np.frombuffer(tf.extractfile(member).read(), np.uint8)
                    img = cv2.imdecode(data, cv2.IMREAD_COLOR)
                    if img is not None:
                        yield cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def __iter__(self):
        rng = self._epoch_rng()
        shards = list(self.shards)
        rng.shuffle(shards)
        buffer = []
        iter_i = 0

        def emit(img):
            nonlocal iter_i
            img = self.transform(image=img, rng=rng)['image']
            mask = self.mask_generator((img.shape[0], img.shape[1]),
                                       iter_i=iter_i, raw_image=img, rng=rng)
            iter_i += 1
            return dict(image=img.astype(np.float32),
                        mask=mask.astype(np.float32))

        for img in self._iter_images(shards):
            buffer.append(img)
            if len(buffer) >= self.shuffle_buffer:
                yield emit(buffer.pop(rng.randint(len(buffer))))
        rng.shuffle(buffer)
        for img in buffer:
            yield emit(img)


class ImgSegmentationDataset:
    """Image + its precomputed semantic segmentation, one-hot over
    `semantic_seg_n_classes` (150: ADE20k), for the segmentation-aware
    ablations (reference datasets.py:64-98), HWC. The segmentation of
    <indir>/x.jpg is <segm_indir>/x.png, label 0 (unlabelled) and 1 both
    class 0."""

    def __init__(self, indir, mask_generator, transform, out_size, segm_indir,
                 semantic_seg_n_classes=150,
                 rng: Optional[np.random.RandomState] = None):
        self.indir = indir
        self.segm_indir = segm_indir
        self.mask_generator = mask_generator
        self.transform = transform
        self.out_size = out_size
        self.semantic_seg_n_classes = semantic_seg_n_classes
        self.in_files = sorted(glob.glob(os.path.join(indir, '**', '*.jpg'),
                                         recursive=True))
        self.rng = rng or np.random.RandomState()

    def __len__(self):
        return len(self.in_files)

    def __getitem__(self, item):
        path = self.in_files[item]
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (self.out_size, self.out_size))
        img = self.transform(image=img, rng=self.rng)['image']
        mask = self.mask_generator((img.shape[0], img.shape[1]),
                                   raw_image=img, rng=self.rng)
        segm, segm_classes = self._load_semantic_segm(path)
        return dict(image=img.astype(np.float32), mask=mask.astype(np.float32),
                    segm=segm, segm_classes=segm_classes)

    def _load_semantic_segm(self, img_path):
        segm_path = img_path.replace(self.indir, self.segm_indir).replace(
            '.jpg', '.png')
        mask = cv2.imread(segm_path, cv2.IMREAD_GRAYSCALE)
        mask = cv2.resize(mask, (self.out_size, self.out_size),
                          interpolation=cv2.INTER_NEAREST)
        classes = np.clip(mask.astype(np.int64) - 1, 0, None)
        one_hot = np.eye(self.semantic_seg_n_classes, dtype=np.float32)[classes]
        return one_hot, classes[..., None]


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


class IterableBatchLoader:
    """Batches of an iterable dataset (web shards); epochs re-iterate and
    a trailing partial batch is dropped. With `epoch_batches` the stream
    is cycled (webdataset's .repeat()) so that every epoch yields exactly
    that many batches; the partial batch carries across cycles, so a
    dataset smaller than a batch still fills batches."""

    def __init__(self, dataset, batch_size=1, epoch_batches=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.epoch_batches = epoch_batches

    def set_epoch(self, epoch):
        set_epoch = getattr(self.dataset, 'set_epoch', None)
        if set_epoch is not None:
            set_epoch(epoch)

    def __iter__(self):
        produced = 0
        set_cycle = getattr(self.dataset, 'set_cycle', None)
        batch = []
        for cycle in itertools.count():
            if set_cycle is not None:
                set_cycle(cycle)
            empty = True
            for item in self.dataset:
                empty = False
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield collate(batch)
                    batch = []
                    produced += 1
                    if (self.epoch_batches is not None
                            and produced >= int(self.epoch_batches)):
                        return
            if self.epoch_batches is None or empty:
                return


def make_default_train_dataloader(indir, kind='default', out_size=512,
                                  mask_gen_kwargs=None, transform_variant='default',
                                  mask_generator_kind='mixed', seed=None,
                                  dataloader_kwargs=None, ddp_kwargs=None, **kwargs):
    """reference datasets.py:206-246."""
    LOGGER.info(f'Make train dataloader {kind} from {indir} '
                f'(mask generator={mask_generator_kind})')
    mask_generator = get_mask_generator(kind=mask_generator_kind,
                                        kwargs=dict(mask_gen_kwargs or {}))
    if seed is not None and kind in ('default', 'default_web'):
        kwargs.setdefault('seed', int(seed))  # per-item fetch RNG base
    transform = get_transforms(transform_variant, out_size)
    if kind == 'default':
        dataset = InpaintingTrainDataset(indir=indir, mask_generator=mask_generator,
                                         transform=transform, **kwargs)
    elif kind == 'default_web':
        if ddp_kwargs is not None:  # disjoint shards per host
            kwargs.setdefault('shard_id', ddp_kwargs.get('rank', 0))
            kwargs.setdefault('num_shards', ddp_kwargs.get('num_replicas', 1))
        dataset = InpaintingTrainWebDataset(indir=indir,
                                            mask_generator=mask_generator,
                                            transform=transform, **kwargs)
        dl_kwargs = dict(dataloader_kwargs or {})
        return IterableBatchLoader(dataset,
                                   batch_size=dl_kwargs.get('batch_size', 1),
                                   epoch_batches=dl_kwargs.get('epoch_batches'))
    elif kind == 'img_with_segm':
        dataset = ImgSegmentationDataset(indir=indir, mask_generator=mask_generator,
                                         transform=transform, out_size=out_size,
                                         **kwargs)
    else:
        raise ValueError(f'Unknown train dataset kind {kind}')
    dl_kwargs = dict(dataloader_kwargs or {})
    if ddp_kwargs is not None:
        dl_kwargs['shard_id'] = ddp_kwargs.get('rank', 0)
        dl_kwargs['num_shards'] = ddp_kwargs.get('num_replicas', 1)
    dl_kwargs.setdefault('drop_last', True)
    return BatchLoader(dataset, **dl_kwargs)


def make_default_val_dataset(indir, kind='default', out_size=512,
                             transform_variant=None, **kwargs):
    """reference datasets.py:249-289; a list of directories is the
    ConcatDataset of theirs."""
    if isinstance(indir, (tuple, list)):
        return ConcatDataset([
            make_default_val_dataset(idir, kind=kind, out_size=out_size,
                                     transform_variant=transform_variant, **kwargs)
            for idir in indir])
    LOGGER.info(f'Make val dataset {kind} from {indir}')
    if kind == 'default':
        kwargs.pop('mask_generator_kind', None)
        kwargs.pop('mask_gen_kwargs', None)
        return InpaintingDataset(indir, **kwargs)
    if kind == 'our_eval':
        return OurInpaintingDataset(indir, **kwargs)
    if kind == 'online':
        mask_generator = get_mask_generator(
            kind=kwargs.pop('mask_generator_kind', None),
            kwargs=kwargs.pop('mask_gen_kwargs', None))
        return InpaintingEvalOnlineDataset(indir=indir,
                                           mask_generator=mask_generator, **kwargs)
    raise ValueError(f'Unknown val dataset kind {kind}')


def make_constant_area_crop_params(img_height, img_width, min_size=128,
                                   max_size=512, area=256 * 256, round_to_mod=16,
                                   rng=None):
    """A random crop of about constant pixel area (reference
    datasets.py:292-304): (start_y, start_x, height, width)."""
    r = rng or np.random
    min_size = min(img_height, img_width, min_size)
    max_size = min(img_height, img_width, max_size)
    if r.random() < 0.5:
        out_height = min(max_size, ceil_modulo(r.randint(min_size, max_size),
                                               round_to_mod))
        out_width = min(max_size, ceil_modulo(area // out_height, round_to_mod))
    else:
        out_width = min(max_size, ceil_modulo(r.randint(min_size, max_size),
                                              round_to_mod))
        out_height = min(max_size, ceil_modulo(area // out_width, round_to_mod))
    start_y = r.randint(0, img_height - out_height + 1)
    start_x = r.randint(0, img_width - out_width + 1)
    return (start_y, start_x, out_height, out_width)
