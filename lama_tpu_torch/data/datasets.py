"""Evaluation datasets of the predict CLI: copies of
lama_tpu/data/datasets.py:232-297 (InpaintingDataset, OurInpaintingDataset)
and :603-623 (make_default_val_dataset, kinds `default` and `our_eval`), so
the port imports nothing of lama_tpu. Kind `online` raises."""
import glob
import logging
import os
from typing import Dict

import cv2
import numpy as np

from .io import load_image, pad_img_to_modulo, scale_image

LOGGER = logging.getLogger(__name__)


class InpaintingDataset:
    """Fixed eval pairs: *mask*.png + <stem><img_suffix>
    (reference evaluation/data.py:58-83), HWC."""

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
