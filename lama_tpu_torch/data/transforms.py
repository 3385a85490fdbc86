"""Host-side augmentation pipeline (cv2/numpy) replacing albumentations+imgaug.

A copy of lama_tpu/data/transforms.py, so the port imports nothing of
lama_tpu.

Provides the same `transform_variant` registry as the reference
(saicinpainting/training/data/datasets.py:101-203): 'default', 'distortions',
'distortions_scale*', 'distortions_light', 'non_space_transform', 'no_augs'.
Augmentations are semantically equivalent (same kinds, ranges and application
probabilities) but are independent implementations over uint8 HWC arrays with
an explicit RandomState.
"""
from typing import List, Optional, Tuple

import cv2
import numpy as np


class Transform:
    p: float = 0.5

    def __call__(self, img, rng):
        if rng.rand() < self.p:
            return self.apply(img, rng)
        return img


class Compose:
    def __init__(self, transforms: List[Transform]):
        self.transforms = transforms

    def __call__(self, image, rng=None):
        rng = rng if rng is not None else np.random.RandomState()
        for t in self.transforms:
            image = t(image, rng)
        return {'image': image}


class ToFloat(Transform):
    p = 2.0  # always

    def apply(self, img, rng):
        return img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img


class HorizontalFlip(Transform):
    def apply(self, img, rng):
        return img[:, ::-1].copy()


class RandomScale(Transform):
    def __init__(self, scale_limit=0.2, p=0.5):
        self.scale_limit = scale_limit
        self.p = p

    def apply(self, img, rng):
        factor = 1.0 + rng.uniform(-self.scale_limit, self.scale_limit)
        return cv2.resize(img, dsize=None, fx=factor, fy=factor,
                          interpolation=cv2.INTER_LINEAR)


class PadIfNeeded(Transform):
    p = 2.0  # always

    def __init__(self, min_height, min_width):
        self.min_height = min_height
        self.min_width = min_width

    def apply(self, img, rng):
        h, w = img.shape[:2]
        if h >= self.min_height and w >= self.min_width:
            return img
        pad_h = max(0, self.min_height - h)
        pad_w = max(0, self.min_width - w)
        top, left = pad_h // 2, pad_w // 2
        return cv2.copyMakeBorder(img, top, pad_h - top, left, pad_w - left,
                                  cv2.BORDER_REFLECT_101)


class RandomCrop(Transform):
    p = 2.0  # always

    def __init__(self, height, width):
        self.height = height
        self.width = width

    def apply(self, img, rng):
        h, w = img.shape[:2]
        assert h >= self.height and w >= self.width, (img.shape, self.height, self.width)
        y0 = rng.randint(0, h - self.height + 1)
        x0 = rng.randint(0, w - self.width + 1)
        return img[y0:y0 + self.height, x0:x0 + self.width]


class CLAHE(Transform):
    def __init__(self, clip_limit=4.0, tile_grid_size=(8, 8), p=0.5):
        self.clip_limit = clip_limit
        self.tile_grid_size = tile_grid_size
        self.p = p

    def apply(self, img, rng):
        clip = rng.uniform(1.0, self.clip_limit)
        clahe = cv2.createCLAHE(clipLimit=clip, tileGridSize=self.tile_grid_size)
        lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
        lab[..., 0] = clahe.apply(lab[..., 0])
        return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)


class RandomBrightnessContrast(Transform):
    def __init__(self, brightness_limit=0.2, contrast_limit=0.2, p=0.5):
        self.brightness_limit = brightness_limit
        self.contrast_limit = contrast_limit
        self.p = p

    def apply(self, img, rng):
        alpha = 1.0 + rng.uniform(-self.contrast_limit, self.contrast_limit)
        beta = rng.uniform(-self.brightness_limit, self.brightness_limit)
        out = img.astype(np.float32) * alpha + beta * 255.0
        return np.clip(out, 0, 255).astype(img.dtype)


class HueSaturationValue(Transform):
    def __init__(self, hue_shift_limit=5, sat_shift_limit=30, val_shift_limit=5, p=0.5):
        self.hue_shift_limit = hue_shift_limit
        self.sat_shift_limit = sat_shift_limit
        self.val_shift_limit = val_shift_limit
        self.p = p

    def apply(self, img, rng):
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int32)
        hsv[..., 0] = (hsv[..., 0] + rng.randint(-self.hue_shift_limit, self.hue_shift_limit + 1)) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] + rng.randint(-self.sat_shift_limit, self.sat_shift_limit + 1), 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] + rng.randint(-self.val_shift_limit, self.val_shift_limit + 1), 0, 255)
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


class Perspective(Transform):
    """Four-corner jitter perspective warp (imgaug PerspectiveTransform
    equivalent; reference aug.py:57-84)."""

    def __init__(self, scale=(0.05, 0.1), p=0.5):
        self.scale = scale
        self.p = p

    def apply(self, img, rng):
        h, w = img.shape[:2]
        sigma = rng.uniform(*self.scale)
        jitter = rng.normal(0, sigma, size=(4, 2)) * np.array([w, h])
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        dst = (src + jitter.astype(np.float32))
        matrix = cv2.getPerspectiveTransform(src, np.float32(dst))
        return cv2.warpPerspective(img, matrix, (w, h), borderMode=cv2.BORDER_REPLICATE)


class Affine(Transform):
    """Random scale/rotate/shear around the centre (imgaug Affine equivalent;
    reference aug.py:4-54)."""

    def __init__(self, scale=(0.7, 1.3), rotate=(0.0, 0.0), shear=(-0.1, 0.1), p=0.5):
        self.scale = scale
        self.rotate = rotate
        self.shear = shear
        self.p = p

    def apply(self, img, rng):
        h, w = img.shape[:2]
        scale = rng.uniform(*self.scale)
        angle = rng.uniform(*self.rotate) if self.rotate != (0.0, 0.0) else 0.0
        shear_x = rng.uniform(*self.shear)
        shear_y = rng.uniform(*self.shear)
        m_rot = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
        m_shear = np.array([[1, shear_x, -shear_x * h / 2],
                            [shear_y, 1, -shear_y * w / 2]], np.float32)
        m = np.vstack([m_rot, [0, 0, 1]]) @ np.vstack([m_shear, [0, 0, 1]])
        return cv2.warpAffine(img, m[:2], (w, h), borderMode=cv2.BORDER_REFLECT)


class OpticalDistortion(Transform):
    def __init__(self, distort_limit=0.05, shift_limit=0.05, p=0.5):
        self.distort_limit = distort_limit
        self.shift_limit = shift_limit
        self.p = p

    def apply(self, img, rng):
        h, w = img.shape[:2]
        k = rng.uniform(-self.distort_limit, self.distort_limit)
        dx = round(rng.uniform(-self.shift_limit, self.shift_limit) * w)
        dy = round(rng.uniform(-self.shift_limit, self.shift_limit) * h)
        fx = fy = w
        cx, cy = w * 0.5 + dx, h * 0.5 + dy
        camera = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        distortion = np.array([k, k, 0, 0, 0], np.float32)
        map1, map2 = cv2.initUndistortRectifyMap(camera, distortion, None, None,
                                                 (w, h), cv2.CV_32FC1)
        return cv2.remap(img, map1, map2, interpolation=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT_101)


_COLOR_TAIL = lambda: [CLAHE(), RandomBrightnessContrast(0.2, 0.2),
                       HueSaturationValue(5, 30, 5), ToFloat()]


def get_transforms(transform_variant, out_size):
    """Registry parity with reference datasets.py:101-203."""
    if transform_variant == 'default':
        return Compose([RandomScale(0.2), PadIfNeeded(out_size, out_size),
                        RandomCrop(out_size, out_size), HorizontalFlip()]
                       + _COLOR_TAIL())
    if transform_variant == 'distortions':
        return Compose([Perspective((0.0, 0.06)), Affine((0.7, 1.3), (-40, 40), (-0.1, 0.1)),
                        PadIfNeeded(out_size, out_size), OpticalDistortion(),
                        RandomCrop(out_size, out_size), HorizontalFlip()]
                       + _COLOR_TAIL())
    if transform_variant == 'distortions_scale05_1':
        return Compose([Perspective((0.0, 0.06)), Affine((0.5, 1.0), (-40, 40), (-0.1, 0.1), p=1),
                        PadIfNeeded(out_size, out_size), OpticalDistortion(),
                        RandomCrop(out_size, out_size), HorizontalFlip()]
                       + _COLOR_TAIL())
    if transform_variant == 'distortions_scale03_12':
        return Compose([Perspective((0.0, 0.06)), Affine((0.3, 1.2), (-40, 40), (-0.1, 0.1), p=1),
                        PadIfNeeded(out_size, out_size), OpticalDistortion(),
                        RandomCrop(out_size, out_size), HorizontalFlip()]
                       + _COLOR_TAIL())
    if transform_variant == 'distortions_scale03_07':
        return Compose([Perspective((0.0, 0.06)), Affine((0.3, 0.7), (-40, 40), (-0.1, 0.1), p=1),
                        PadIfNeeded(out_size, out_size), OpticalDistortion(),
                        RandomCrop(out_size, out_size), HorizontalFlip()]
                       + _COLOR_TAIL())
    if transform_variant == 'distortions_light':
        return Compose([Perspective((0.0, 0.02)), Affine((0.8, 1.8), (-20, 20), (-0.03, 0.03)),
                        PadIfNeeded(out_size, out_size),
                        RandomCrop(out_size, out_size), HorizontalFlip()]
                       + _COLOR_TAIL())
    if transform_variant == 'non_space_transform':
        return Compose(_COLOR_TAIL())
    if transform_variant == 'no_augs':
        return Compose([ToFloat()])
    raise ValueError(f'Unexpected transform_variant {transform_variant}')
