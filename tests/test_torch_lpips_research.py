"""The port's LPIPS research tail (lama_tpu_torch/evaluation/
lpips_research.py) against lama_tpu's on the CPU: the cases of
tests/test_lpips_research.py on the port, the host scorers equal to
lama_tpu's, DSSIM within 1e-6, Dist2LogitLayer on lama_tpu's variables
carried across (fc1, fc2, fc3 -> the reference's model.0, .2, .4) within
atol 1e-6, the ranking loss within rtol 1e-5 and trainable with torch's
Adam."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lama_tpu.evaluation import lpips_research as jres
from lama_tpu_torch.evaluation.lpips_research import (
    Dist2LogitLayer, DSSIMScore, L2Score, bce_ranking_loss, dssim, l2, psnr,
    rgb2lab, score_2afc_dataset, score_jnd_dataset, voc_ap)

torch.set_num_threads(1)


def dist_l1(a, b):
    return np.abs(a - b).reshape(a.shape[0], -1).mean(axis=1)


def test_score_2afc_agreement_math():
    ref = np.zeros((3, 4, 4, 3), np.float32)
    p0, p1 = np.zeros_like(ref), np.zeros_like(ref)
    p0[0] += 0.1; p1[0] += 0.5   # p0 closer, humans prefer p0 -> 1
    p0[1] += 0.5; p1[1] += 0.1   # p1 closer, humans prefer p0 -> 0
    data = [dict(ref=ref, p0=p0, p1=p1, judge=np.array([0.0, 0.0, 0.3]))]
    score, detail = score_2afc_dataset(data, dist_l1)
    np.testing.assert_allclose(detail['scores'], [1.0, 0.0, 0.5])
    assert score == pytest.approx(0.5)
    want, want_detail = jres.score_2afc_dataset(data, dist_l1)
    assert score == want
    for k in want_detail:
        np.testing.assert_array_equal(detail[k], want_detail[k])
    frac = [dict(ref=ref[:1], p0=ref[:1] + 0.1, p1=ref[:1] + 0.5,
                 judge=np.array([0.6]))]
    assert score_2afc_dataset(frac, dist_l1)[0] == pytest.approx(0.4)


@pytest.mark.parametrize('order', ['good', 'bad'])
def test_score_jnd_ranking(order):
    data = dict(p0=np.zeros((4, 2, 2, 3), np.float32),
                p1=np.zeros((4, 2, 2, 3), np.float32),
                same=np.array([1.0, 1.0, 0.0, 0.0]))
    d = {'good': np.array([0.1, 0.2, 0.8, 0.9]),
         'bad': np.array([0.9, 0.8, 0.2, 0.1])}[order]
    ap, detail = score_jnd_dataset([data], lambda a, b: d)
    want, want_detail = jres.score_jnd_dataset([data], lambda a, b: d)
    assert ap == want
    np.testing.assert_array_equal(detail['ds'], want_detail['ds'])
    assert ap == pytest.approx(1.0) if order == 'good' else ap < 0.6


def test_voc_ap_known_value():
    rng = np.random.RandomState(0)
    rec, prec = np.sort(rng.rand(9)), rng.rand(9)
    for use_07 in (False, True):
        assert voc_ap(rec, prec, use_07) == jres.voc_ap(rec, prec, use_07)
    assert voc_ap(np.array([1.0, 1.0]), np.array([1.0, 0.5])) == \
        pytest.approx(1.0)
    assert voc_ap(np.array([0.0, 1.0]), np.array([0.0, 0.5])) == \
        pytest.approx(0.5)


def test_rgb2lab_and_scalars():
    lab = rgb2lab(np.array([[[1.0, 1.0, 1.0], [0.0, 0.0, 0.0],
                             [1.0, 0.0, 0.0]]], np.float32))
    np.testing.assert_allclose(lab[0, 0], [100.0, 0.0, 0.0], atol=0.2)
    np.testing.assert_allclose(lab[0, 2], [53.24, 80.09, 67.20], atol=0.2)
    rng = np.random.RandomState(1)
    a = rng.rand(16, 16, 3).astype(np.float32) * 255.0
    b = np.clip(a + rng.randn(16, 16, 3) * 40, 0, 255).astype(np.float32)
    np.testing.assert_array_equal(rgb2lab(a / 255), jres.rgb2lab(a / 255))
    assert l2(a, b) == jres.l2(a, b) and psnr(a, b) == jres.psnr(a, b)
    assert l2(a, a) == 0.0 and psnr(a, a) > 100.0
    assert dssim(a, a) == pytest.approx(0.0, abs=1e-5)
    assert 0.0 < dssim(a, b) <= 0.5 + 1e-6
    assert dssim(a, b) == pytest.approx(jres.dssim(a, b), abs=1e-6)
    assert dssim(a[..., 0], b[..., 0]) == pytest.approx(
        jres.dssim(a[..., 0], b[..., 0]), abs=1e-6)     # one channel


@pytest.mark.parametrize('name', ['L2Score', 'DSSIMScore'])
@pytest.mark.parametrize('colorspace', ['RGB', 'Lab'])
def test_fakenet_scorers(name, colorspace):
    rng = np.random.RandomState(2)
    score = {'L2Score': L2Score, 'DSSIMScore': DSSIMScore}[name](colorspace)
    theirs = getattr(jres, name)(colorspace)
    img = rng.rand(2, 16, 16, 3).astype(np.float32)
    near = np.clip(img + rng.randn(*img.shape).astype(np.float32) * 0.01, 0, 1)
    far = np.clip(img + rng.randn(*img.shape).astype(np.float32) * 0.3, 0, 1)
    d_self, d_near, d_far = score(img, img), score(img, near), score(img, far)
    assert d_self.shape == (2,) and d_self.dtype == np.float32
    assert np.all(d_self <= d_near + 1e-6) and np.all(d_near < d_far)
    np.testing.assert_allclose(d_far, theirs(img, far), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match='colorspace'):
        L2Score(colorspace='HSV')


def test_2afc_with_lpips_distance():
    """A tiny 2AFC set scored with the port's LPIPS (random squeeze trunk:
    only the ranking is asserted)."""
    from lama_tpu_torch.evaluation.lpips import LPIPS
    metric = LPIPS(net='squeeze')

    def dist(a, b):
        with torch.no_grad():
            return metric(torch.from_numpy(a).permute(0, 3, 1, 2),
                          torch.from_numpy(b).permute(0, 3, 1, 2)).numpy()

    rng = np.random.RandomState(3)
    ref = rng.rand(2, 32, 32, 3).astype(np.float32)
    p0 = np.clip(ref + rng.randn(*ref.shape).astype(np.float32) * 0.02, 0, 1)
    p1 = np.clip(ref + rng.randn(*ref.shape).astype(np.float32) * 0.5, 0, 1)
    score, _ = score_2afc_dataset(
        [dict(ref=ref, p0=p0, p1=p1, judge=np.zeros(2))], dist)
    assert score == pytest.approx(1.0)


def test_dist2logit_head_and_ranking_loss():
    rng = np.random.RandomState(4)
    d0 = rng.rand(6).astype(np.float32)
    d1 = rng.rand(6).astype(np.float32)
    judge = rng.choice([-1.0, 1.0], 6).astype(np.float32)
    jlayer = jres.Dist2LogitLayer(chn_mid=8)
    v = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(d0), jnp.asarray(d1))
    want = np.asarray(jlayer.apply(v, jnp.asarray(d0), jnp.asarray(d1)))

    layer = Dist2LogitLayer(chn_mid=8)
    sd = {}
    for i, name in ((0, 'fc1'), (2, 'fc2'), (4, 'fc3')):
        p = v['params'][name]
        sd[f'model.{i}.weight'] = torch.from_numpy(
            np.asarray(p['kernel']).transpose(3, 2, 0, 1).copy())
        sd[f'model.{i}.bias'] = torch.from_numpy(np.array(p['bias']))
    layer.load_state_dict(sd, strict=True)
    p_ours = layer(torch.from_numpy(d0), torch.from_numpy(d1))
    assert p_ours.shape == (6,)
    np.testing.assert_allclose(p_ours.detach().numpy(), want, rtol=0, atol=1e-6)
    assert torch.all((p_ours >= 0) & (p_ours <= 1))

    loss0 = bce_ranking_loss(p_ours, torch.from_numpy(judge)).detach()
    assert float(loss0) == pytest.approx(
        float(jres.bce_ranking_loss(jnp.asarray(want), jnp.asarray(judge))),
        rel=1e-5)
    opt = torch.optim.Adam(layer.parameters(), lr=1e-2)
    for _ in range(60):
        opt.zero_grad()
        loss = bce_ranking_loss(layer(torch.from_numpy(d0), torch.from_numpy(d1)),
                                torch.from_numpy(judge))
        loss.backward()
        opt.step()
    assert float(loss.detach()) < float(loss0) * 0.7
