"""Activation registry (counterpart of lama_tpu/ops/activations.py, after the
reference's modules/base.py:43-50)."""
import torch
import torch.nn.functional as F


def identity(x):
    return x


def leaky_relu_02(x):
    return F.leaky_relu(x, negative_slope=0.2)


_ACTIVATIONS = {
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'relu': torch.relu,
    'leaky_relu': leaky_relu_02,
    False: identity,
    'identity': identity,
    'none': identity,
}


def get_activation(kind='tanh'):
    if callable(kind):
        return kind
    if kind in _ACTIVATIONS:
        return _ACTIVATIONS[kind]
    raise ValueError(f'Unknown activation kind {kind}')
