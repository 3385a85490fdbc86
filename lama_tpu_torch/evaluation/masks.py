"""Object-shaped mask synthesis (counterpart of lama_tpu/evaluation/masks.py;
reference evaluation/masks/mask.py): masks made by augmenting the 'thing'
instances of a panoptic segmentation (scale, flip, shift) and checking each
placement against mask-mask and mask-foreground intersection limits on a
COUNTLESS-downsampled map. Host numpy and cv2, copied from lama_tpu.

The predictor is any callable `img -> (panoptic_seg (H, W) int array,
segments_info [{'id', 'isthing'}, ...])`; the default is the ADE20k
segmenter with connected-component instances (segm_backend.py). Where
lama_tpu draws from the global `np.random`, `get_masks` takes an `rng`
(a `np.random.RandomState`, the global one when None): `RandomState(s)`
draws what `np.random.seed(s)` does, so the two give the same masks.
"""
import enum
from copy import deepcopy
from typing import Callable, List, Optional

import cv2
import numpy as np

from .countless import zero_corrected_countless


class ObjectMask:
    """Bbox-cropped binary mask with flip/rescale/shift/crop-to-canvas algebra.

    Method for method the reference's (mask.py:19-132): any drift in the
    flip / rescale / shift algebra changes the masks made."""

    def __init__(self, mask):
        self.height, self.width = mask.shape
        (self.up, self.down), (self.left, self.right) = self._get_limits(mask)
        self.mask = mask[self.up:self.down, self.left:self.right].copy()

    @staticmethod
    def _get_limits(mask):
        def limits(indicator):
            lower = indicator.argmax()
            upper = len(indicator) - indicator[::-1].argmax()
            return int(lower), int(upper)

        return limits(mask.any(axis=1)), limits(mask.any(axis=0))

    def _clean(self):
        self.up, self.down, self.left, self.right = 0, 0, 0, 0
        self.mask = np.empty((0, 0), dtype=bool)

    def horizontal_flip(self, inplace=False):
        if not inplace:
            return deepcopy(self).horizontal_flip(inplace=True)
        self.mask = self.mask[:, ::-1]
        return self

    def vertical_flip(self, inplace=False):
        if not inplace:
            return deepcopy(self).vertical_flip(inplace=True)
        self.mask = self.mask[::-1, :]
        return self

    def image_center(self):
        return (self.up + (self.down - self.up) / 2,
                self.left + (self.right - self.left) / 2)

    def rescale(self, scaling_factor, inplace=False):
        if not inplace:
            return deepcopy(self).rescale(scaling_factor, inplace=True)
        h, w = self.mask.shape
        nh, nw = max(1, int(round(h * scaling_factor))), max(1, int(round(w * scaling_factor)))
        scaled_mask = cv2.resize(self.mask.astype(np.float32), (nw, nh),
                                 interpolation=cv2.INTER_NEAREST) > 0.5
        if not scaled_mask.any():
            self._clean()
            return self
        (up, down), (left, right) = self._get_limits(scaled_mask)
        self.mask = scaled_mask[up:down, left:right]
        y_center, x_center = self.image_center()
        mh, mw = self.mask.shape
        self.up = int(round(y_center - mh / 2))
        self.down = self.up + mh
        self.left = int(round(x_center - mw / 2))
        self.right = self.left + mw
        return self

    def crop_to_canvas(self, vertical=True, horizontal=True, inplace=False):
        if not inplace:
            return deepcopy(self).crop_to_canvas(vertical=vertical,
                                                 horizontal=horizontal, inplace=True)
        if vertical:
            if self.up >= self.height or self.down <= 0:
                self._clean()
            else:
                cut_up = max(-self.up, 0)
                cut_down = max(self.down - self.height, 0)
                if cut_up:
                    self.mask = self.mask[cut_up:]
                    self.up = 0
                if cut_down:
                    self.mask = self.mask[:-cut_down]
                    self.down = self.height
        if horizontal:
            if self.left >= self.width or self.right <= 0:
                self._clean()
            else:
                cut_left = max(-self.left, 0)
                cut_right = max(self.right - self.width, 0)
                if cut_left:
                    self.mask = self.mask[:, cut_left:]
                    self.left = 0
                if cut_right:
                    self.mask = self.mask[:, :-cut_right]
                    self.right = self.width
        return self

    def restore_full_mask(self, allow_crop=False):
        cropped = self.crop_to_canvas(inplace=allow_crop)
        mask = np.zeros((cropped.height, cropped.width), dtype=bool)
        mask[cropped.up:cropped.down, cropped.left:cropped.right] = cropped.mask
        return mask

    def shift(self, vertical=0, horizontal=0, inplace=False):
        if not inplace:
            return deepcopy(self).shift(vertical=vertical, horizontal=horizontal,
                                        inplace=True)
        self.up += vertical
        self.down += vertical
        self.left += horizontal
        self.right += horizontal
        return self

    def area(self):
        return self.mask.sum()


class RigidnessMode(enum.Enum):
    soft = 0
    rigid = 1


class SegmentationMask:
    """reference mask.py:140-407; `predictor` replaces detectron2."""

    def __init__(self, predictor: Optional[Callable] = None,
                 confidence_threshold=0.5, rigidness_mode=RigidnessMode.rigid,
                 max_object_area=0.3, min_mask_area=0.02, downsample_levels=6,
                 num_variants_per_mask=4, max_mask_intersection=0.5,
                 max_foreground_coverage=0.5, max_foreground_intersection=0.5,
                 max_hidden_area=0.2, max_scale_change=0.25, horizontal_flip=True,
                 max_vertical_shift=0.1, position_shuffle=True):
        if predictor is None:
            # the ADE20k segmenter with connected-component instances
            # (segm_backend.py) in place of the reference's detectron2
            from .segm_backend import make_default_predictor
            predictor = make_default_predictor()
        self.predictor = predictor
        self.confidence_threshold = confidence_threshold
        self.rigidness_mode = RigidnessMode(rigidness_mode)
        self.max_object_area = max_object_area
        self.min_mask_area = min_mask_area
        self.downsample_levels = downsample_levels
        self.num_variants_per_mask = num_variants_per_mask
        self.max_mask_intersection = max_mask_intersection
        self.max_foreground_coverage = max_foreground_coverage
        self.max_foreground_intersection = max_foreground_intersection
        self.max_hidden_area = max_hidden_area
        self.position_shuffle = position_shuffle
        self.max_scale_change = max_scale_change
        self.horizontal_flip = horizontal_flip
        self.max_vertical_shift = max_vertical_shift

    @staticmethod
    def _is_power_of_two(n):
        return (n != 0) and (n & (n - 1) == 0)

    def identify_candidates(self, panoptic_seg, segments_info):
        ids = []
        for segment in segments_info:
            if not segment['isthing']:
                continue
            mask = panoptic_seg == segment['id']
            if mask.sum() / np.prod(panoptic_seg.shape) >= self.max_object_area:
                continue
            ids.append(segment['id'])
        return ids

    def downsample_mask(self, mask):
        height, width = mask.shape
        if not (self._is_power_of_two(height) and self._is_power_of_two(width)):
            raise ValueError('Image sides are not power of 2.')
        num_iterations = width.bit_length() - 1 - self.downsample_levels
        if num_iterations < 0:
            raise ValueError(f'Width is lower than 2^{self.downsample_levels}.')
        if height.bit_length() - 1 < num_iterations:
            raise ValueError('Height is too low to perform downsampling')
        downsampled = mask
        for _ in range(num_iterations):
            downsampled = zero_corrected_countless(downsampled)
        return downsampled

    def _augmentation_params(self, rng):
        return {
            'scaling_factor': rng.uniform(1 - self.max_scale_change,
                                          1 + self.max_scale_change),
            'horizontal_flip': bool(rng.choice(2)) if self.horizontal_flip else False,
            'vertical_shift': rng.uniform(-self.max_vertical_shift,
                                          self.max_vertical_shift),
        }

    @staticmethod
    def _get_intersection(mask_array, mask_object):
        return mask_array[mask_object.up:mask_object.down,
                          mask_object.left:mask_object.right] & mask_object.mask

    def _check_masks_intersection(self, aug_mask, total_mask_area, prev_masks):
        for existing_mask in prev_masks:
            intersection_area = self._get_intersection(existing_mask, aug_mask).sum()
            intersection_existing = intersection_area / existing_mask.sum()
            intersection_current = 1 - (aug_mask.area() - intersection_area) / total_mask_area
            if (intersection_existing > self.max_mask_intersection or
                    intersection_current > self.max_mask_intersection):
                return False
        return True

    def _check_foreground_intersection(self, aug_mask, foreground):
        for existing_mask in foreground:
            intersection_area = self._get_intersection(existing_mask, aug_mask).sum()
            if intersection_area / existing_mask.sum() > self.max_foreground_coverage:
                return False
            if intersection_area / max(aug_mask.area(), 1) > self.max_foreground_intersection:
                return False
        return True

    def _move_mask(self, mask, foreground, rng):
        """Search augmented placements of one object mask (mask.py:271-351)."""
        orig_mask = ObjectMask(mask)
        chosen_masks = []
        chosen_parameters = []
        scaling_factor_lower_bound = 0.0

        for _ in range(self.num_variants_per_mask):
            params = self._augmentation_params(rng)
            params['scaling_factor'] = min([
                params['scaling_factor'],
                2 * min(orig_mask.up, orig_mask.height - orig_mask.down) / orig_mask.height + 1.0,
                2 * min(orig_mask.left, orig_mask.width - orig_mask.right) / orig_mask.width + 1.0,
            ])
            params['scaling_factor'] = max(params['scaling_factor'],
                                           scaling_factor_lower_bound)

            aug_mask = deepcopy(orig_mask)
            aug_mask.rescale(params['scaling_factor'], inplace=True)
            if params['horizontal_flip']:
                aug_mask.horizontal_flip(inplace=True)
            total_aug_area = aug_mask.area()
            if total_aug_area == 0:
                scaling_factor_lower_bound = 1.0
                continue

            vertical_area = aug_mask.mask.sum(axis=1) / total_aug_area
            max_hidden_up = np.searchsorted(vertical_area.cumsum(), self.max_hidden_area)
            max_hidden_down = np.searchsorted(vertical_area[::-1].cumsum(), self.max_hidden_area)
            params['vertical_shift'] = np.clip(
                params['vertical_shift'],
                -(aug_mask.up + max_hidden_up) / aug_mask.height,
                (aug_mask.height - aug_mask.down + max_hidden_down) / aug_mask.height)
            vertical_shift = int(round(aug_mask.height * params['vertical_shift']))
            aug_mask.shift(vertical=vertical_shift, inplace=True)
            aug_mask.crop_to_canvas(vertical=True, horizontal=False, inplace=True)

            max_hidden_area = self.max_hidden_area - (1 - aug_mask.area() / total_aug_area)
            horizontal_area = aug_mask.mask.sum(axis=0) / total_aug_area
            max_hidden_left = np.searchsorted(horizontal_area.cumsum(), max_hidden_area)
            max_hidden_right = np.searchsorted(horizontal_area[::-1].cumsum(), max_hidden_area)
            allowed_shifts = np.arange(-max_hidden_left,
                                       aug_mask.width - (aug_mask.right - aug_mask.left)
                                       + max_hidden_right + 1)
            allowed_shifts = -(aug_mask.left - allowed_shifts)
            if self.position_shuffle:
                rng.shuffle(allowed_shifts)

            mask_is_found = False
            for horizontal_shift in allowed_shifts:
                candidate = deepcopy(aug_mask)
                candidate.shift(horizontal=int(horizontal_shift), inplace=True)
                candidate.crop_to_canvas(inplace=True)
                if candidate.area() == 0:
                    continue
                prev_masks = [mask] + chosen_masks
                if (self._check_masks_intersection(candidate, total_aug_area, prev_masks)
                        and self._check_foreground_intersection(candidate, foreground)):
                    chosen_masks.append(candidate.restore_full_mask())
                    params['horizontal_shift'] = horizontal_shift / candidate.width
                    chosen_parameters.append(params)
                    mask_is_found = True
                    break
            if not mask_is_found:
                break
        return chosen_parameters

    def _prepare_mask(self, mask):
        height, width = mask.shape
        tw = width if self._is_power_of_two(width) else (1 << width.bit_length())
        th = height if self._is_power_of_two(height) else (1 << height.bit_length())
        return cv2.resize(mask.astype('float32'), (tw, th),
                          interpolation=cv2.INTER_NEAREST).round().astype('int32')

    def get_masks(self, im, return_panoptic=False, rng=None) -> List[np.ndarray]:
        rng = rng if rng is not None else np.random
        panoptic_seg, segments_info = self.predictor(im)
        panoptic_seg = np.asarray(panoptic_seg)
        potential_mask_ids = self.identify_candidates(panoptic_seg, segments_info)

        downsampled = self.downsample_mask(self._prepare_mask(panoptic_seg))
        scene_objects = [downsampled == s['id'] for s in segments_info
                         if s['isthing'] and np.any(downsampled == s['id'])]

        mask_set = []
        for mask_id in potential_mask_ids:
            mask = downsampled == mask_id
            if not np.any(mask):
                continue
            foreground = [mask] if self.rigidness_mode is RigidnessMode.soft \
                else scene_objects
            masks_params = self._move_mask(mask, foreground, rng)
            full_mask = ObjectMask(panoptic_seg == mask_id)
            for params in masks_params:
                aug_mask = deepcopy(full_mask)
                aug_mask.rescale(params['scaling_factor'], inplace=True)
                if params['horizontal_flip']:
                    aug_mask.horizontal_flip(inplace=True)
                vertical_shift = int(round(aug_mask.height * params['vertical_shift']))
                horizontal_shift = int(round(aug_mask.width * params['horizontal_shift']))
                aug_mask.shift(vertical=vertical_shift, horizontal=horizontal_shift,
                               inplace=True)
                aug_mask = aug_mask.restore_full_mask().astype('uint8')
                if aug_mask.mean() <= self.min_mask_area:
                    continue
                mask_set.append(aug_mask)

        if return_panoptic:
            return mask_set, panoptic_seg
        return mask_set
