"""Training visualizers (reference saicinpainting/training/visualizers/),
a copy of lama_tpu/training/visualizers.py, so the port imports nothing of
lama_tpu:
DirectoryVisualizer writes [image | predicted | discr maps | inpainted] grids
with mask boundaries marked, every visualize_each_iters steps, rank 0 only.

NHWC numpy; boundary marking via cv2 morphological gradient (replaces the
reference's skimage mark_boundaries — skimage is unavailable here).
"""
import logging
import os
from typing import Dict, List, Optional

import cv2
import numpy as np

LOGGER = logging.getLogger(__name__)


def mark_mask_boundaries(img: np.ndarray, mask: np.ndarray,
                         color=(1.0, 0.0, 0.0)) -> np.ndarray:
    """Draw mask boundary on an HWC [0,1] image."""
    m = (np.asarray(mask[..., 0]) > 0.5).astype(np.uint8)
    kernel = np.ones((3, 3), np.uint8)
    boundary = cv2.morphologyEx(m, cv2.MORPH_GRADIENT, kernel).astype(bool)
    out = img.copy()
    out[boundary] = color
    return out


def visualize_mask_and_images(images_dict: Dict[str, np.ndarray], keys: List[str],
                              last_without_mask=True, rescale_keys=None,
                              mask_only_first=False, black_mask=False) -> np.ndarray:
    """One sample row: HWC images side by side with boundaries marked
    (reference visualizers/base.py:24-50 semantics)."""
    mask = images_dict['mask']
    result = []
    for i, k in enumerate(keys):
        img = np.asarray(images_dict[k], dtype=np.float32)
        if rescale_keys is not None and k in rescale_keys:
            img = img - img.min()
            img = img / (img.max() + 1e-5)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        elif img.shape[-1] > 3:
            img_classes = img.argmax(-1)
            img = np.stack([(img_classes % 10) / 10.0,
                            (img_classes % 7) / 7.0,
                            (img_classes % 5) / 5.0], axis=-1)
        if black_mask and i == 0:
            img = img * (1 - (np.asarray(mask[..., :1]) > 0.5))
        draw_boundary = (i == 0) if mask_only_first else \
            (i < len(keys) - 1 or not last_without_mask)
        if draw_boundary:
            img = mark_mask_boundaries(img, mask)
        result.append(np.clip(img, 0, 1))
    return np.concatenate(result, axis=1)


def visualize_mask_and_images_batch(batch: Dict[str, np.ndarray], keys: List[str],
                                    max_items=10, last_without_mask=True,
                                    rescale_keys=None) -> np.ndarray:
    batch = {k: np.asarray(v) for k, v in batch.items()
             if k in keys or k == 'mask'}
    batch_size = min(batch['image'].shape[0], max_items)
    rows = []
    for i in range(batch_size):
        sample = {k: v[i] for k, v in batch.items()}
        rows.append(visualize_mask_and_images(sample, keys,
                                              last_without_mask=last_without_mask,
                                              rescale_keys=rescale_keys))
    return np.concatenate(rows, axis=0)


class NoopVisualizer:
    def __call__(self, *args, **kwargs):
        pass


class DirectoryVisualizer:
    """reference visualizers/directory.py:10-36."""
    DEFAULT_KEY_ORDER = 'image predicted_image inpainted'.split(' ')

    def __init__(self, outdir, key_order=None, max_items_in_batch=10,
                 last_without_mask=True, rescale_keys=None):
        self.outdir = outdir
        os.makedirs(self.outdir, exist_ok=True)
        self.key_order = key_order or self.DEFAULT_KEY_ORDER
        self.max_items_in_batch = max_items_in_batch
        self.last_without_mask = last_without_mask
        self.rescale_keys = rescale_keys

    def __call__(self, epoch_i, batch_i, batch, suffix='', rank=None):
        keys = [k for k in self.key_order if k in batch]
        vis_img = visualize_mask_and_images_batch(
            batch, keys, max_items=self.max_items_in_batch,
            last_without_mask=self.last_without_mask, rescale_keys=self.rescale_keys)
        vis_img = np.clip(vis_img * 255, 0, 255).astype('uint8')
        curoutdir = os.path.join(self.outdir, f'epoch{epoch_i:04d}{suffix}')
        os.makedirs(curoutdir, exist_ok=True)
        rank_suffix = f'_r{rank}' if rank is not None else ''
        out_fname = os.path.join(curoutdir, f'batch{batch_i:07d}{rank_suffix}.jpg')
        cv2.imwrite(out_fname, cv2.cvtColor(vis_img, cv2.COLOR_RGB2BGR))


def make_visualizer(kind, **kwargs):
    LOGGER.info(f'Make visualizer {kind}')
    if kind == 'directory':
        return DirectoryVisualizer(**kwargs)
    if kind == 'noop':
        return NoopVisualizer()
    raise ValueError(f'Unknown visualizer kind {kind}')
