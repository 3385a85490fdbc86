"""The default segmentation backend of the object-shaped masks (counterpart
of lama_tpu/evaluation/segm_backend.py): the ADE20k segmenter
(models/aux/segmentation.py) on `device`, its label map made
pseudo-panoptic on the host by connected components (8-connectivity, cv2)
over the 'thing' classes (Stuff == 0 in object150_info.csv); the reference
uses detectron2's PanopticFPN (evaluation/masks/mask.py:7-14).

Interface (what SegmentationMask expects of a predictor):
    img (H, W, C) float [0, 1] -> (panoptic_seg (H, W) int array,
                                   segments_info: [{'id', 'isthing'}, ...])
"""
import csv
import os
from typing import Optional

import cv2
import numpy as np

_RESOURCES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          'resources')


def ade20k_thing_class_ids() -> frozenset:
    """0-based ADE20k class indices that are 'things' (instance-like)."""
    with open(os.path.join(_RESOURCES, 'object150_info.csv')) as f:
        return frozenset(int(row['Idx']) - 1 for row in csv.DictReader(f)
                         if int(row['Stuff']) == 0)


class ADE20kPanopticPredictor:
    """Semantic ADE20k labels -> pseudo-panoptic segments. Builds the
    segmenter on first use (weights from `weights_path` or $TORCH_HOME);
    without both ADE20k files it refuses, unless `allow_random_weights`
    (placements from random weights are arbitrary: pipeline runs only)."""

    def __init__(self, weights_path: Optional[str] = None,
                 segmentation_module=None, min_instance_area: float = 1e-3,
                 arch_encoder: str = 'resnet50dilated',
                 allow_random_weights: bool = False, device='cuda'):
        self._module = segmentation_module
        self.weights_path = weights_path if weights_path is not None \
            else os.environ.get('TORCH_HOME')
        self.min_instance_area = min_instance_area
        self.arch_encoder = arch_encoder
        self.allow_random_weights = allow_random_weights
        self.device = device
        self.thing_ids = ade20k_thing_class_ids()

    @property
    def module(self):
        if self._module is None:
            from ..models.aux.segmentation import (SegmentationModule,
                                                   resolve_ade20k_weight_paths)
            enc, _ = resolve_ade20k_weight_paths(self.weights_path,
                                                 self.arch_encoder)
            if enc is None and not self.allow_random_weights:
                raise RuntimeError(
                    f'ADE20k segmenter weights not found under '
                    f'{self.weights_path!r} (set $TORCH_HOME or weights_path; '
                    'see fetch_data/). Object-shaped masks from RANDOM weights '
                    'are arbitrary — pass allow_random_weights=True to the '
                    'predictor only for pipeline smoke tests.')
            self._module = SegmentationModule(weights_path=self.weights_path,
                                              arch_encoder=self.arch_encoder,
                                              device=self.device)
        return self._module

    def __call__(self, img):
        img = np.asarray(img, dtype=np.float32)
        if img.max() > 1.5:  # uint8-scaled input
            img = img / 255.0
        labels, _ = self.module.predict(img[None])
        return self.panoptic(np.asarray(labels[0]))

    def panoptic(self, labels):
        """A label map (H, W) -> (panoptic_seg, segments_info): one segment
        per stuff class, one per connected component of at least
        min_instance_area of the image per thing class."""
        panoptic = np.zeros(labels.shape, dtype=np.int32)
        segments_info = []
        next_id = 1
        min_px = self.min_instance_area * labels.size
        for cls in np.unique(labels):
            cls_mask = labels == cls
            if int(cls) not in self.thing_ids:
                panoptic[cls_mask] = next_id
                segments_info.append({'id': next_id, 'isthing': False,
                                      'category_id': int(cls)})
                next_id += 1
                continue
            n, comps = cv2.connectedComponents(cls_mask.astype(np.uint8),
                                               connectivity=8)
            for comp_i in range(1, n):
                comp_mask = comps == comp_i
                if comp_mask.sum() < min_px:
                    continue
                panoptic[comp_mask] = next_id
                segments_info.append({'id': next_id, 'isthing': True,
                                      'category_id': int(cls)})
                next_id += 1
        return panoptic, segments_info


def make_default_predictor(**kwargs) -> ADE20kPanopticPredictor:
    return ADE20kPanopticPredictor(**kwargs)
