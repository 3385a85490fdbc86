"""Eval-set visualisation helpers (a copy of lama_tpu/evaluation/vis.py;
reference evaluation/vis.py:6-37): host cv2 on HWC [0, 1] images."""
import cv2
import numpy as np

from ..training.visualizers import mark_mask_boundaries


def save_item_for_vis(item, out_file):
    """image with mask boundary + alpha-darkened hole."""
    mask = item['mask'] > 0.5
    img = mark_mask_boundaries(np.asarray(item['image'], np.float32), item['mask'])
    img = img * (1 - 0.5 * mask) + 0.5 * mask * np.array([1.0, 0, 0])
    img = np.clip(img * 255, 0, 255).astype('uint8')
    cv2.imwrite(out_file, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def save_mask_for_sidebyside(item, out_file):
    mask = np.asarray(item['mask'])
    if mask.ndim == 3:
        mask = mask[..., 0]
    cv2.imwrite(out_file, np.clip(mask * 255, 0, 255).astype('uint8'))


def save_img_for_sidebyside(item, out_file):
    img = np.clip(np.asarray(item['image']) * 255, 0, 255).astype('uint8')
    cv2.imwrite(out_file, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def save_masked_img_for_sidebyside(item, out_file):
    mask = np.asarray(item['mask'])
    img = np.asarray(item['image'])
    img = (1 - mask) * img + mask
    img = np.clip(img * 255, 0, 255).astype('uint8')
    cv2.imwrite(out_file, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
