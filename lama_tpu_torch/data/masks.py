"""Procedural mask synthesis — host-side (numpy/cv2), feeding the device
pipeline.

A copy of lama_tpu/data/masks.py, so the port imports nothing of lama_tpu;
the segmentation-mask kind runs the port's object-shaped masks
(evaluation/masks.py) with the ADE20k segmenter (evaluation/segm_backend.py).

Same mask *distributions* as the reference (saicinpainting/training/data/
masks.py): polyline brush strokes, random boxes, periodic super-resolution
stripes, fixed-area squares, border outpainting strips, and a probability
mixture with curriculum ramps. Deliberately kept on host: the drawing is
branchy and sequential, and is never the bottleneck (SURVEY §7 design stance).

Differences from the reference:
- masks are returned HWC (H, W, 1) float32 — NHWC convention;
- every generator takes an optional `rng` (np.random.Generator/RandomState)
  for deterministic per-worker streams (the reference mutates global state).

Shapes passed in are CHW or HWC agnostic: generators only need (H, W), taken
via the `img_shape_hw` helper from a CHW image array like the reference, or an
explicit (H, W) tuple.
"""
import hashlib
import logging
import math
import threading
from enum import Enum
from typing import Optional, Tuple

import cv2
import numpy as np

from ..utils.ramps import LinearRamp

LOGGER = logging.getLogger(__name__)


class DrawMethod(Enum):
    LINE = 'line'
    CIRCLE = 'circle'
    SQUARE = 'square'


def _rng(rng):
    return rng if rng is not None else np.random


def img_shape_hw(img) -> Tuple[int, int]:
    """(H, W) from a CHW image (reference convention) or an (H, W) tuple."""
    if isinstance(img, tuple):
        return img
    if img.ndim == 3 and img.shape[0] in (1, 3, 4):  # CHW
        return img.shape[1], img.shape[2]
    return img.shape[0], img.shape[1]  # HW(C)


def make_random_irregular_mask(shape, max_angle=4, max_len=60, max_width=20,
                               min_times=0, max_times=10,
                               draw_method=DrawMethod.LINE, rng=None):
    """Brush-stroke masks: random walks of thick segments
    (reference masks.py:22-48 distribution)."""
    r = _rng(rng)
    draw_method = DrawMethod(draw_method)
    height, width = shape
    mask = np.zeros((height, width), np.float32)
    for stroke_i in range(r.randint(min_times, max_times + 1)):
        x = r.randint(width)
        y = r.randint(height)
        for _ in range(1 + r.randint(5)):
            angle = 0.01 + r.randint(max_angle)
            if stroke_i % 2 == 0:
                angle = 2 * 3.1415926 - angle
            length = 10 + r.randint(max_len)
            brush_w = 5 + r.randint(max_width)
            end_x = int(np.clip(x + length * np.sin(angle), 0, width))
            end_y = int(np.clip(y + length * np.cos(angle), 0, height))
            if draw_method == DrawMethod.LINE:
                cv2.line(mask, (x, y), (end_x, end_y), 1.0, brush_w)
            elif draw_method == DrawMethod.CIRCLE:
                cv2.circle(mask, (x, y), radius=brush_w, color=1.0, thickness=-1)
            elif draw_method == DrawMethod.SQUARE:
                radius = brush_w // 2
                mask[max(0, y - radius):y + radius, max(0, x - radius):x + radius] = 1
            x, y = end_x, end_y
    return mask[..., None]


def make_random_rectangle_mask(shape, margin=10, bbox_min_size=30,
                               bbox_max_size=100, min_times=0, max_times=3,
                               rng=None):
    """Random box masks (reference masks.py:72-84 distribution)."""
    r = _rng(rng)
    height, width = shape
    mask = np.zeros((height, width), np.float32)
    bbox_max_size = min(bbox_max_size, height - margin * 2, width - margin * 2)
    for _ in range(r.randint(min_times, max_times + 1)):
        bw = r.randint(bbox_min_size, bbox_max_size)
        bh = r.randint(bbox_min_size, bbox_max_size)
        x0 = r.randint(margin, width - margin - bw + 1)
        y0 = r.randint(margin, height - margin - bh + 1)
        mask[y0:y0 + bh, x0:x0 + bw] = 1
    return mask[..., None]


def make_random_superres_mask(shape, min_step=2, max_step=4, min_width=1,
                              max_width=3, rng=None):
    """Periodic row/column stripes (reference masks.py:118-133)."""
    r = _rng(rng)
    height, width = shape
    mask = np.zeros((height, width), np.float32)
    step_x = r.randint(min_step, max_step + 1)
    width_x = r.randint(min_width, min(step_x, max_width + 1))
    offset_x = r.randint(0, step_x)
    step_y = r.randint(min_step, max_step + 1)
    width_y = r.randint(min_width, min(step_y, max_width + 1))
    offset_y = r.randint(0, step_y)
    for dy in range(width_y):
        mask[offset_y + dy::step_y] = 1
    for dx in range(width_x):
        mask[:, offset_x + dx::step_x] = 1
    return mask[..., None]


class RandomIrregularMaskGenerator:
    """Irregular masks with a LinearRamp curriculum on len/width/count
    (reference masks.py:51-69)."""

    def __init__(self, max_angle=4, max_len=60, max_width=20, min_times=0,
                 max_times=10, ramp_kwargs=None, draw_method=DrawMethod.LINE):
        self.max_angle = max_angle
        self.max_len = max_len
        self.max_width = max_width
        self.min_times = min_times
        self.max_times = max_times
        self.draw_method = draw_method
        self.ramp = LinearRamp(**ramp_kwargs) if ramp_kwargs is not None else None

    def __call__(self, img, iter_i=None, raw_image=None, rng=None):
        coef = self.ramp(iter_i) if (self.ramp is not None and iter_i is not None) else 1
        return make_random_irregular_mask(
            img_shape_hw(img),
            max_angle=self.max_angle,
            max_len=int(max(1, self.max_len * coef)),
            max_width=int(max(1, self.max_width * coef)),
            min_times=self.min_times,
            max_times=int(self.min_times + 1 + (self.max_times - self.min_times) * coef),
            draw_method=self.draw_method, rng=rng)


class RandomRectangleMaskGenerator:
    """reference masks.py:87-101."""

    def __init__(self, margin=10, bbox_min_size=30, bbox_max_size=100,
                 min_times=0, max_times=3, ramp_kwargs=None):
        self.margin = margin
        self.bbox_min_size = bbox_min_size
        self.bbox_max_size = bbox_max_size
        self.min_times = min_times
        self.max_times = max_times
        self.ramp = LinearRamp(**ramp_kwargs) if ramp_kwargs is not None else None

    def __call__(self, img, iter_i=None, raw_image=None, rng=None):
        coef = self.ramp(iter_i) if (self.ramp is not None and iter_i is not None) else 1
        return make_random_rectangle_mask(
            img_shape_hw(img), margin=self.margin,
            bbox_min_size=self.bbox_min_size,
            bbox_max_size=int(self.bbox_min_size + 1 + (self.bbox_max_size - self.bbox_min_size) * coef),
            min_times=self.min_times,
            max_times=int(self.min_times + (self.max_times - self.min_times) * coef),
            rng=rng)


class RandomSuperresMaskGenerator:
    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def __call__(self, img, iter_i=None, raw_image=None, rng=None):
        return make_random_superres_mask(img_shape_hw(img), rng=rng, **self.kwargs)


class RandomSegmentationMaskGenerator:
    """Object-shaped masks from a panoptic segmenter (reference
    masks.py:104-123; lama_tpu/data/masks.py:176-205): `kwargs` go to
    evaluation/masks.py::SegmentationMask, built on the first call (its
    default predictor, the ADE20k segmenter on the card, needs the ADE20k
    weights or `predictor=` in the kwargs). One of the image's masks that
    holds both values is picked with `rng`, which also draws the
    placements."""

    def __init__(self, **kwargs):
        self.impl = None
        self.kwargs = kwargs
        self._init_lock = threading.Lock()

    def __call__(self, img, iter_i=None, raw_image=None, rng=None):
        if self.impl is None:
            # the loader's worker threads may call concurrently; build once
            with self._init_lock:
                if self.impl is None:
                    from ..evaluation.masks import SegmentationMask
                    self.impl = SegmentationMask(**self.kwargs)
        # the datasets pass the (h, w) shape as `img` (the other generators
        # need only that) and the pixels as `raw_image`
        image = img if hasattr(img, 'ndim') else raw_image
        if image is None or not hasattr(image, 'ndim'):
            raise ValueError(
                'RandomSegmentationMaskGenerator needs the image pixels: the '
                'dataset must pass raw_image= (got only a shape tuple)')
        hwc = (np.transpose(image, (1, 2, 0))
               if image.ndim == 3 and image.shape[0] in (1, 3) else image)
        r = _rng(rng)
        masks = [m for m in self.impl.get_masks(hwc, rng=r)
                 if len(np.unique(m)) > 1]
        return masks[r.randint(len(masks))][..., None].astype(np.float32)


class DumbAreaMaskGenerator:
    """Square mask of roughly constant area: random placement in training,
    centred at eval (reference masks.py:144-173)."""
    min_ratio = 0.1
    max_ratio = 0.35
    default_ratio = 0.225

    def __init__(self, is_training):
        self.is_training = is_training

    def _span(self, dimension, r):
        if self.is_training:
            lo, hi = math.sqrt(self.min_ratio), math.sqrt(self.max_ratio)
            side = round((r.random() * (hi - lo) + lo) * dimension)
            u = r.randint(0, dimension - side)
            return u, u + side
        margin = (math.sqrt(self.default_ratio) / 2) * dimension
        return round(dimension / 2 - margin), round(dimension / 2 + margin)

    def __call__(self, img, iter_i=None, raw_image=None, rng=None):
        r = _rng(rng)
        height, width = img_shape_hw(img)
        mask = np.zeros((height, width), np.float32)
        x1, x2 = self._span(width, r)
        y1, y2 = self._span(height, r)
        mask[x1:x2, y1:y2] = 1
        return mask[..., None]


class OutpaintingMaskGenerator:
    """Border-strip masks on up to 4 sides with per-side probabilities
    (reference masks.py:176-249); optional per-image deterministic RNG via
    sha1 of the raw image."""

    def __init__(self, min_padding_percent: float = 0.04,
                 max_padding_percent: float = 0.25,
                 left_padding_prob: float = 0.5, top_padding_prob: float = 0.5,
                 right_padding_prob: float = 0.5, bottom_padding_prob: float = 0.5,
                 is_fixed_randomness: bool = False):
        assert 0 < max_padding_percent <= 1 and 0 <= min_padding_percent <= max_padding_percent
        self.min_padding_percent = min_padding_percent
        self.max_padding_percent = max_padding_percent
        self.probs = [left_padding_prob, top_padding_prob,
                      right_padding_prob, bottom_padding_prob]
        assert sum(self.probs) > 0 and all(0 <= p <= 1 for p in self.probs)
        self.is_fixed_randomness = is_fixed_randomness

    def _pad_fraction(self, size, r):
        lo = int(self.min_padding_percent * size)
        hi = int(self.max_padding_percent * size)
        return r.randint(lo, hi) / size

    @staticmethod
    def _image_seed(raw_image):
        digest = hashlib.sha1(np.ascontiguousarray(raw_image.astype(np.uint8))).hexdigest()
        return int(digest, 16) % (2 ** 32)

    def __call__(self, img, iter_i=None, raw_image=None, rng=None):
        height, width = img_shape_hw(img)
        if self.is_fixed_randomness:
            assert raw_image is not None, 'fixed randomness needs raw_image'
            r = np.random.RandomState(self._image_seed(raw_image))
        else:
            r = _rng(rng)
        mask = np.zeros((height, width), np.float32)

        def strips():
            return [
                ((0.0, 0.0), (1.0, self._pad_fraction(height, r))),   # left
                ((0.0, 0.0), (self._pad_fraction(width, r), 1.0)),    # top
                ((0.0, 1.0 - self._pad_fraction(height, r)), (1.0, 1.0)),  # right
                ((1.0 - self._pad_fraction(width, r), 0.0), (1.0, 1.0)),   # bottom
            ]

        coords = strips()

        def paint(coord):
            (r0, c0), (r1, c1) = coord
            mask[int(r0 * height):int(r1 * height), int(c0 * width):int(c1 * width)] = 1

        applied = False
        for p, coord in zip(self.probs, coords):
            if r.random() < p:
                applied = True
                paint(coord)
        if not applied:
            idx = r.choice(range(len(coords)), p=np.asarray(self.probs) / sum(self.probs))
            paint(coords[idx])
        return mask[..., None]


class MixedMaskGenerator:
    """Probability mixture over mask kinds + optional inversion
    (reference masks.py:252-315). Train default = irregular + box
    (configs/training/data/abl-04-256-mh-dist.yaml)."""

    def __init__(self, irregular_proba=1 / 3, irregular_kwargs=None,
                 box_proba=1 / 3, box_kwargs=None,
                 segm_proba=1 / 3, segm_kwargs=None,
                 squares_proba=0, squares_kwargs=None,
                 superres_proba=0, superres_kwargs=None,
                 outpainting_proba=0, outpainting_kwargs=None,
                 invert_proba=0):
        self.probas = []
        self.gens = []

        def add(proba, ctor, kwargs, **extra):
            if proba > 0:
                self.probas.append(proba)
                self.gens.append(ctor(**{**(dict(kwargs) if kwargs else {}), **extra}))

        add(irregular_proba, RandomIrregularMaskGenerator, irregular_kwargs,
            draw_method=DrawMethod.LINE)
        add(box_proba, RandomRectangleMaskGenerator, box_kwargs)
        add(segm_proba, RandomSegmentationMaskGenerator, segm_kwargs)
        add(squares_proba, RandomIrregularMaskGenerator, squares_kwargs,
            draw_method=DrawMethod.SQUARE)
        add(superres_proba, RandomSuperresMaskGenerator, superres_kwargs)
        add(outpainting_proba, OutpaintingMaskGenerator, outpainting_kwargs)

        self.probas = np.asarray(self.probas, dtype='float32')
        self.probas /= self.probas.sum()
        self.invert_proba = invert_proba

    def __call__(self, img, iter_i=None, raw_image=None, rng=None):
        r = _rng(rng)
        kind = r.choice(len(self.probas), p=self.probas)
        result = self.gens[kind](img, iter_i=iter_i, raw_image=raw_image, rng=rng)
        if self.invert_proba > 0 and r.random() < self.invert_proba:
            result = 1 - result
        return result


def get_mask_generator(kind, kwargs):
    """reference masks.py:318-332."""
    if kind is None:
        kind = 'mixed'
    if kwargs is None:
        kwargs = {}
    cls = {'mixed': MixedMaskGenerator,
           'outpainting': OutpaintingMaskGenerator,
           'dumb': DumbAreaMaskGenerator}.get(kind)
    if cls is None:
        raise NotImplementedError(f'No such generator kind = {kind}')
    return cls(**kwargs)
