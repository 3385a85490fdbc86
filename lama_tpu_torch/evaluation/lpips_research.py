"""LPIPS research tail (counterpart of lama_tpu/evaluation/lpips_research.py;
reference saicinpainting/evaluation/losses/lpips.py:436-697): the 2AFC / JND
dataset scoring that validates a perceptual metric against human
judgements, the VOC average precision it uses, the L2 / DSSIM "FakeNet"
baseline scorers (RGB or CIELab), and the Dist2LogitLayer / BCE ranking
head that trains a metric on 2AFC triplets.

No config or CLI of the repository calls these; they complete the metric
stack. The scorers take iterables of dicts of NHWC numpy batches and a
distance function (e.g. `lama_tpu_torch.evaluation.scores.LPIPSScore`), and
are host numpy copied from lama_tpu; DSSIM uses the port's SSIM
(evaluation/ssim.py) on the CPU. Dist2LogitLayer is an nn.Module with the
reference's keys (`model.0`, `.2`, `.4`: three 1x1 convs with bias).
"""
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn as nn

__all__ = ['score_2afc_dataset', 'score_jnd_dataset', 'voc_ap', 'rgb2lab',
           'l2', 'psnr', 'dssim', 'L2Score', 'DSSIMScore', 'Dist2LogitLayer',
           'bce_ranking_loss']


# ---------------------------------------------------------------------------
# dataset scoring (reference lpips.py:436-511)
# ---------------------------------------------------------------------------

def score_2afc_dataset(data_iter: Iterable[Dict], dist_fn: Callable,
                       ) -> Tuple[float, Dict[str, np.ndarray]]:
    """Two-Alternative-Forced-Choice score of a distance function.

    `data_iter` yields dicts with 'ref', 'p0', 'p1' (NHWC [0,1] image
    batches) and 'judge' (N human preferences in [0,1]; 0 = humans preferred
    p0, 1 = p1). `dist_fn(a, b)` returns N distances. Returns (mean
    agreement in [0,1], per-triplet arrays) - reference
    lpips.py::score_2afc_dataset semantics, including the 0.5 credit on
    exact ties.
    """
    d0s, d1s, gts = [], [], []
    for data in data_iter:
        d0s.append(np.asarray(dist_fn(data['ref'], data['p0'])).ravel())
        d1s.append(np.asarray(dist_fn(data['ref'], data['p1'])).ravel())
        gts.append(np.asarray(data['judge']).ravel())
    d0s = np.concatenate(d0s) if d0s else np.zeros(0)
    d1s = np.concatenate(d1s) if d1s else np.zeros(0)
    gts = np.concatenate(gts) if gts else np.zeros(0)
    scores = ((d0s < d1s) * (1.0 - gts) + (d1s < d0s) * gts
              + (d1s == d0s) * 0.5)
    mean = float(scores.mean()) if scores.size else float('nan')
    return mean, dict(d0s=d0s, d1s=d1s, gts=gts, scores=scores)


def score_jnd_dataset(data_iter: Iterable[Dict], dist_fn: Callable,
                      ) -> Tuple[float, Dict[str, np.ndarray]]:
    """Just-Noticeable-Difference mAP of a distance function.

    `data_iter` yields dicts with 'p0', 'p1' (NHWC image batches) and 'same'
    (N fractions of humans who judged the pair identical). Sorting pairs by
    ascending distance, 'same' plays ground-truth positive; the score is the
    VOC AP of that ranking (reference lpips.py::score_jnd_dataset).
    """
    ds, sames = [], []
    for data in data_iter:
        ds.append(np.asarray(dist_fn(data['p0'], data['p1'])).ravel())
        sames.append(np.asarray(data['same']).ravel())
    ds = np.concatenate(ds) if ds else np.zeros(0)
    sames = np.concatenate(sames) if sames else np.zeros(0)
    order = np.argsort(ds)
    sames_sorted = sames[order]
    tps = np.cumsum(sames_sorted)
    fps = np.cumsum(1 - sames_sorted)
    fns = sames_sorted.sum() - tps
    precs = tps / np.maximum(tps + fps, 1e-12)
    recs = tps / np.maximum(tps + fns, 1e-12)
    return voc_ap(recs, precs), dict(ds=ds[order], sames=sames_sorted)


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """PASCAL-VOC average precision (reference lpips.py:134-165): 11-point
    interpolation for the 2007 metric, else the exact area under the
    monotonised precision envelope."""
    rec = np.asarray(rec, np.float64)
    prec = np.asarray(prec, np.float64)
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


# ---------------------------------------------------------------------------
# colorspace + scalar baselines (reference lpips.py:50-132)
# ---------------------------------------------------------------------------

def rgb2lab(rgb: np.ndarray) -> np.ndarray:
    """sRGB [0,1] HWC (or NHWC) -> CIELab, D65 white point (closed form; the
    reference routes through skimage.color.rgb2lab)."""
    rgb = np.asarray(rgb, np.float64)
    lin = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                   rgb / 12.92)
    m = np.array([[0.412453, 0.357580, 0.180423],
                  [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]])
    xyz = lin @ m.T
    xyz = xyz / np.array([0.950456, 1.0, 1.088754])  # D65 normalisation
    f = np.where(xyz > 0.008856, np.cbrt(xyz), 7.787 * xyz + 16.0 / 116.0)
    lab = np.empty_like(xyz)
    lab[..., 0] = np.where(xyz[..., 1] > 0.008856,
                           116.0 * f[..., 1] - 16.0, 903.3 * xyz[..., 1])
    lab[..., 1] = 500.0 * (f[..., 0] - f[..., 1])
    lab[..., 2] = 200.0 * (f[..., 1] - f[..., 2])
    return lab.astype(np.float32)


def l2(p0: np.ndarray, p1: np.ndarray, data_range: float = 255.0) -> float:
    """Mean squared error normalised to [0,1] by data_range^2 (reference
    lpips.py:50-51)."""
    return float(np.mean((np.asarray(p0, np.float64)
                          - np.asarray(p1, np.float64)) ** 2)
                 / data_range ** 2)


def psnr(p0: np.ndarray, p1: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio (reference lpips.py:54-55)."""
    mse = np.mean((np.asarray(p0, np.float64)
                   - np.asarray(p1, np.float64)) ** 2)
    return float(10 * np.log10(peak ** 2 / max(mse, 1e-12)))


def dssim(p0: np.ndarray, p1: np.ndarray, data_range: float = 255.0) -> float:
    """Structural-dissimilarity (1 - SSIM)/2 in [0,1] (reference
    lpips.py:58-59), with the port's SSIM (gaussian 11x11); the reference
    calls skimage's uniform-window variant."""
    from .ssim import ssim as _ssim
    a = np.asarray(p0, np.float32) / data_range
    b = np.asarray(p1, np.float32) / data_range
    if a.ndim == 2:  # HW -> HW1
        a, b = a[..., None], b[..., None]
    a, b = (torch.from_numpy(np.ascontiguousarray(v.transpose(2, 0, 1)))[None]
            for v in (a, b))
    return float((1.0 - _ssim(a, b)[0].item()) / 2.0)


class _FakeNetScore:
    """Distance-function adapter with the reference FakeNet call contract:
    score(in0, in1) over NHWC [0,1] batches -> N distances (lpips.py:660+).
    colorspace 'Lab' (default, reference) or 'RGB'."""

    def __init__(self, colorspace: str = 'Lab'):
        if colorspace not in ('Lab', 'RGB'):
            raise ValueError(f'Unknown colorspace {colorspace}')
        self.colorspace = colorspace

    def _pair(self, a, b) -> float:
        raise NotImplementedError

    def __call__(self, in0, in1) -> np.ndarray:
        in0 = np.asarray(in0, np.float32)
        in1 = np.asarray(in1, np.float32)
        if in0.ndim == 3:
            in0, in1 = in0[None], in1[None]
        return np.array([self._pair(a, b) for a, b in zip(in0, in1)],
                        np.float32)


class L2Score(_FakeNetScore):
    """The 'l2' baseline of the 2AFC benchmark (reference lpips.py::L2)."""

    def _pair(self, a, b) -> float:
        if self.colorspace == 'RGB':
            return l2(a * 255.0, b * 255.0, data_range=255.0)
        return l2(rgb2lab(a), rgb2lab(b), data_range=100.0)


class DSSIMScore(_FakeNetScore):
    """The 'ssim' baseline of the 2AFC benchmark (reference
    lpips.py::DSSIM)."""

    def _pair(self, a, b) -> float:
        if self.colorspace == 'RGB':
            return dssim(a * 255.0, b * 255.0, data_range=255.0)
        # Lab channels live on different scales; normalise by L's range as
        # the reference does (range=100)
        return dssim(rgb2lab(a), rgb2lab(b), data_range=100.0)


# ---------------------------------------------------------------------------
# trainable ranking head (reference lpips.py:624-655)
# ---------------------------------------------------------------------------

class Dist2LogitLayer(nn.Module):
    """Maps two per-image distances to P(human prefers p1): three 1x1 convs
    over the 5-feature stack (d0, d1, d0-d1, d0/(d1+eps), d1/(d0+eps)),
    LeakyReLU(0.2), sigmoid head (reference lpips.py::Dist2LogitLayer)."""

    def __init__(self, chn_mid: int = 32, use_sigmoid: bool = True,
                 eps: float = 0.1):
        super().__init__()
        self.eps = eps
        layers = [nn.Conv2d(5, chn_mid, 1), nn.LeakyReLU(0.2),
                  nn.Conv2d(chn_mid, chn_mid, 1), nn.LeakyReLU(0.2),
                  nn.Conv2d(chn_mid, 1, 1)]
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.model = nn.Sequential(*layers)

    def forward(self, d0, d1):
        d0 = torch.as_tensor(d0).reshape(-1, 1, 1, 1).float()
        d1 = torch.as_tensor(d1).reshape(-1, 1, 1, 1).float()
        x = torch.cat([d0, d1, d0 - d1, d0 / (d1 + self.eps),
                       d1 / (d0 + self.eps)], dim=1)
        return self.model(x).reshape(-1)


def bce_ranking_loss(logit, judge, eps: float = 1e-7):
    """BCE between the Dist2LogitLayer output and the human preference
    mapped from [-1,1] to [0,1] (reference lpips.py::BCERankingLoss)."""
    per = (torch.as_tensor(judge).reshape(-1).float() + 1.0) / 2.0
    p = torch.clamp(logit.reshape(-1), eps, 1.0 - eps)
    return -torch.mean(per * torch.log(p) + (1.0 - per) * torch.log(1.0 - p))
