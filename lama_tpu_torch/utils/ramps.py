"""Schedule ramps used by mask-synthesis curricula and train-time rescaling.

A copy of lama_tpu/utils/ramps.py, so the port imports nothing of lama_tpu.

Semantics match the reference (saicinpainting/utils.py:66-98): a ramp maps an
iteration counter to a scalar; `LinearRamp` interpolates between two values over
[start_iter, end_iter]; `LadderRamp` is a step function over iteration thresholds.
These run on host (data pipeline), so plain Python/numpy is correct here.
"""
import bisect

import numpy as np


class LinearRamp:
    def __init__(self, start_value=0, end_value=1, start_iter=-1, end_iter=0):
        self.start_value = start_value
        self.end_value = end_value
        self.start_iter = start_iter
        self.end_iter = end_iter

    def __call__(self, i):
        if i < self.start_iter:
            return self.start_value
        if i >= self.end_iter:
            return self.end_value
        part = (i - self.start_iter) / (self.end_iter - self.start_iter)
        return self.start_value * (1 - part) + self.end_value * part


class LadderRamp:
    def __init__(self, start_iters, values):
        self.start_iters = start_iters
        self.values = values
        assert len(values) == len(start_iters) + 1, (len(values), len(start_iters))

    def __call__(self, i):
        segment_i = bisect.bisect_right(self.start_iters, i)
        return self.values[segment_i]


def get_ramp(kind='ladder', **kwargs):
    if kind == 'linear':
        return LinearRamp(**kwargs)
    if kind == 'ladder':
        return LadderRamp(**kwargs)
    raise ValueError(f'Unexpected ramp kind: {kind}')
