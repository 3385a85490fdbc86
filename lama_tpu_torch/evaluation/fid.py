"""FID: InceptionV3 pooled activations on the device, the Frechet distance
on the host (counterpart of lama_tpu/evaluation/fid.py; reference
evaluation/losses/base_loss.py:127-218 and losses/fid/).

`calculate_frechet_distance` is a copy of lama_tpu/evaluation/fid.py:20-48:
scipy's sqrtm on the host, its eps fallback for a singular product and
the imaginary-part check.
"""
import logging
import os
from typing import Optional

import numpy as np
import torch

from ..models.aux.inception import FIDInceptionV3, fid_state_dict
from ..models.aux.random_init import seeded_random_init_
from .utils import no_tf32

LOGGER = logging.getLogger(__name__)


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """Frechet distance between two gaussians (reference base_loss.py:127-153,
    with the singular-covariance eps fallback)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if isinstance(covmean, tuple):  # older scipy (disp API) compatibility
        covmean = covmean[0]
    if not np.isfinite(covmean).all():
        LOGGER.warning(f'fid calculation produces singular product; '
                       f'adding {eps} to diagonal of cov estimates')
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))

    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f'Imaginary component {m}')
        covmean = covmean.real

    return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
            - 2 * np.trace(covmean))


def fid_from_activations(act1: np.ndarray, act2: np.ndarray) -> float:
    mu1, sigma1 = act1.mean(axis=0), np.cov(act1, rowvar=False)
    mu2, sigma2 = act2.mean(axis=0), np.cov(act2, rowvar=False)
    return float(calculate_frechet_distance(mu1, sigma1, mu2, sigma2))


class InceptionActivations:
    """The frozen FID InceptionV3 on `device`: NHWC [0, 1] numpy images ->
    (B, 2048) float32 numpy activations. Weights: pytorch-fid's
    pt_inception file when `weights_path` exists, else seeded random
    weights (models/aux/random_init.py), with a warning."""

    _instances = {}

    def __init__(self, device='cuda', weights_path: Optional[str] = None,
                 seed: int = 0, state_dict=None):
        self.device = torch.device(device)
        self.model = FIDInceptionV3(output_blocks=(3,))
        if state_dict is None and weights_path and os.path.exists(weights_path):
            state_dict = torch.load(weights_path, map_location='cpu',
                                    weights_only=False)
            LOGGER.info(f'FID inception weights loaded from {weights_path}')
        if state_dict is not None:
            self.model.load_state_dict(fid_state_dict(state_dict))
        else:
            seeded_random_init_(self.model, seed)
            LOGGER.warning('FID inception weights unavailable '
                           f'({weights_path}); RANDOM weights (seed {seed}): '
                           'FID values are only self-consistent, not '
                           'comparable.')
        self.model.to(self.device).eval().requires_grad_(False)

    @classmethod
    def get(cls, device='cuda', **kwargs):
        """One instance a process and device (the reference's FIDScore
        caches its inception); the weights are the first call's."""
        key = str(torch.device(device))
        if key not in cls._instances:
            weights_path = kwargs.pop('weights_path', None) or \
                os.environ.get('LAMA_FID_INCEPTION_WEIGHTS')
            cls._instances[key] = cls(device=device, weights_path=weights_path,
                                      **kwargs)
        return cls._instances[key]

    @torch.no_grad()
    def activations(self, images: torch.Tensor) -> torch.Tensor:
        """NCHW [0, 1] tensor on the device -> (B, 2048) on the device, in
        true float32 (TF32 off)."""
        with no_tf32():
            out = self.model(images)[0]
        return out.reshape(out.shape[0], -1)

    def __call__(self, images) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(
            self.device).permute(0, 3, 1, 2)
        return self.activations(x).cpu().numpy()
