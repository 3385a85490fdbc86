"""The port's segmentation-aware scores (lama_tpu_torch/evaluation/
segm_scores.py) and `evaluate_predicts` with the segm metrics against
lama_tpu's on the CPU.

- The host algebra, exactly: one stub segmenter (a fixed numpy function of
  the pixels) in both packages; SegmentationClassStats and a stub pairwise
  score (a fixed numpy value per image) give the same bincounts and the
  same per-class dicts, key for key and bit for bit, total and per group,
  from their own accumulators and from `states`; SegmentationAwareFID's
  leave-one-out attribution on the same (256-d) activation states, with
  tests/torch_eval_common.py's exact_frechet in both packages and both
  packages' process pools (lama_tpu's joblib, the port's spawned workers)
  in process, since their workers would not see the stand-in; the port's
  pool itself is held to the serial loop on scipy's Frechet distance. In
  the chain below the Frechet
  distance is `lowrank_frechet` (exact for covariances of few samples,
  held here to exact_frechet; scipy's 2048-d sqrtm takes 12-16 s on this
  CPU).
- The chain through the real nets: four pairs of the eval2 dataset of
  tests/torch_eval_common.py (64^2; three in the 0-10% bin), the score
  nets on the
  same weights, the ADE20k mobilenetv2dilated segmenter (C1-deepsup) on
  He-scaled JAX variables carried across (resnet50dilated is held in
  tests/test_torch_segmentation.py; here it would take most of a minute
  of CPU). Where the two segmenters' labels differ, the
  pixel must be a near-tie (lama_tpu's scores for both labels within twice
  the largest score difference; at most 0.1% of the pixels), and
  lama_tpu's side takes the port's label there, so that both count the
  same pixels; `python -m lama_tpu_torch.evaluate_predicts
  configs/eval2_segm.yaml --metrics ssim,segm_stats,segm_ssim,segm_lpips,
  segm_fid --device cpu` against bin/evaluate_predicts.py's run_evaluation
  (SSIM atol 1e-6, the rest rtol 1e-3 / atol 2e-4), its table as pandas'
  text; without --metrics the segm config runs ssim, lpips and fid only.
"""
import io
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_eval_common import (ATOL, RTOL, exact_frechet, lowrank_frechet,
                               random_variables, score_setup)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'bin'))
EVAL2_SEGM = os.path.join(REPO, 'configs', 'eval2_segm.yaml')
SEGM_METRICS = 'ssim,segm_stats,segm_ssim,segm_lpips,segm_fid'


class StubSegmenter:
    """Labels from the pixels, the same numpy function in both packages."""

    def predict(self, images, seg_size=None):
        x = np.asarray(images)
        labels = (np.floor(x[..., 0] * 6) * 25 + np.floor(x[..., 1] * 5) * 5
                  + np.floor(x[..., 2] * 5)).astype(np.int64) % 150
        return labels, None


def stub_pairwise(module):
    class MeanAbsDiff(module.SegmentationAwarePairwiseScore):
        def calc_score(self, pred_batch, target_batch, mask):
            return np.abs(pred_batch - target_batch).mean(axis=(1, 2, 3))
    return MeanAbsDiff


def batches(n_batches=3, b=4, size=32, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        target = rng.rand(b, size, size, 3).astype(np.float32)
        pred = np.clip(target + 0.2 * rng.randn(*target.shape), 0, 1
                       ).astype(np.float32)
        mask = (rng.rand(b, size, size, 1) < rng.rand(b, 1, 1, 1)
                ).astype(np.float32)
        out.append((pred, target, mask))
    return out


def assert_same(ours, theirs):
    """The same keys in the same order, bit-equal values (NaN where NaN)."""
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert type(ours[k]) is type(v), (k, type(ours[k]), type(v))
        assert ours[k] == v or (np.isnan(v) and np.isnan(ours[k])), (k, ours[k], v)


def assert_same_results(ours, theirs):
    assert_same(ours[0], theirs[0])
    if theirs[1] is None:
        assert ours[1] is None
        return
    assert list(ours[1]) == list(theirs[1])
    for label in theirs[1]:
        assert_same(ours[1][label], theirs[1][label])


GROUPS = np.array([0, 2, 2, 1, 0, 0, 2, 1, 2, 0, 2, 3])   # group 3: one image


@pytest.mark.parametrize('kind', ['stats', 'pairwise'])
def test_segm_host_algebra_is_lama_tpus(kind):
    from lama_tpu.evaluation import segm_scores as jsegm
    from lama_tpu_torch.evaluation import segm_scores as segm
    if kind == 'stats':
        ours = segm.SegmentationClassStats(segm_network=StubSegmenter(),
                                           device='cpu')
        theirs = jsegm.SegmentationClassStats(segm_network=StubSegmenter())
    else:
        ours = stub_pairwise(segm)(segm_network=StubSegmenter(), device='cpu')
        theirs = stub_pairwise(jsegm)(segm_network=StubSegmenter())
    states_ours, states_theirs = [], []
    for pred, target, mask in batches():
        a, b = ours(pred, target, mask), theirs(pred, target, mask)
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        states_ours.append(a)
        states_theirs.append(b)
    assert states_ours[0][0].shape == (4, 150)
    assert (states_ours[0][1] > 0).sum() > 20     # many classes in the masks
    for groups in (GROUPS, None):
        assert_same_results(ours.get_value(groups=groups, states=states_ours),
                            theirs.get_value(groups=groups, states=states_theirs))
    for pred, target, mask in batches():
        ours(pred, target, mask)
        theirs(pred, target, mask)
    res = ours.get_value(groups=GROUPS)
    assert_same_results(res, theirs.get_value(groups=GROUPS))
    assert len(res[0]) > 20 and set(res[1]) == {0, 1, 2, 3}
    assert ours.target_class_freq_by_image_total == []   # reset after


def test_lowrank_frechet_is_exact_frechet():
    rng = np.random.RandomState(4)
    a = rng.randn(6, 2048)
    b = a + 0.3 * rng.randn(6, 2048)
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    want = exact_frechet(*args)
    assert lowrank_frechet(*args) == pytest.approx(want, rel=1e-6)


def serial_leave_one_out(act_pred, act_target):
    from lama_tpu_torch.evaluation.segm_scores import _fid_without_image
    return [_fid_without_image(i, act_pred, act_target)
            for i in range(act_pred.shape[0])]


def test_leave_one_out_pool_is_the_serial_loop():
    """The port's pool of spawned workers returns the serial loop's
    leave-one-out FIDs, in the images' order (scipy's Frechet distance,
    64-d; the workers' BLAS takes fewer threads, so rtol 1e-9)."""
    from lama_tpu_torch.evaluation.segm_scores import leave_one_out_fids
    rng = np.random.RandomState(8)
    act_t = rng.randn(5, 64)
    act_p = act_t + rng.randn(5, 64) * np.linspace(0.1, 2, 5)[:, None]
    want = serial_leave_one_out(act_p, act_t)
    got = leave_one_out_fids(act_p, act_t)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert len(set(np.round(want, 6))) == 5


@pytest.fixture
def frechet_stand_in(monkeypatch):
    """exact_frechet in both packages; both packages' process pools in
    process (their workers would not see the patch)."""
    import joblib
    from lama_tpu.evaluation import fid as jfid
    from lama_tpu_torch.evaluation import segm_scores

    def in_process(n_jobs=None, **kwargs):
        return lambda tasks: [f(*a, **k) for f, a, k in tasks]

    monkeypatch.setattr(joblib, 'Parallel', in_process)
    monkeypatch.setattr(segm_scores, 'leave_one_out_fids',
                        serial_leave_one_out)
    monkeypatch.setattr(jfid, 'calculate_frechet_distance', exact_frechet)
    monkeypatch.setattr(segm_scores, 'calculate_frechet_distance',
                        exact_frechet)


def test_segm_fid_leave_one_out_is_lama_tpus(frechet_stand_in, monkeypatch):
    """The same states (bincounts and activation pairs) through both
    packages' SegmentationAwareFID: the FID of each group of two or more
    and every class's leave-one-out attribution bit-equal; NaN for a group
    of one."""
    from lama_tpu.evaluation import fid as jfid
    from lama_tpu.evaluation import segm_scores as jsegm
    from lama_tpu_torch.evaluation import fid, segm_scores as segm
    monkeypatch.setattr(jfid.InceptionActivations, '_singleton', object())
    monkeypatch.setattr(fid.InceptionActivations, '_instances',
                        {'cpu': object()})
    ours = segm.SegmentationAwareFID(segm_network=StubSegmenter(), device='cpu')
    theirs = jsegm.SegmentationAwareFID(segm_network=StubSegmenter())
    rng = np.random.RandomState(5)
    states = []
    for pred, target, mask in batches(n_batches=2, b=3):
        totals, masks, preds = segm.SegmentationAwareScore.__call__(
            ours, pred, target, mask)
        act_t = rng.randn(3, 256).astype(np.float32)
        act_p = (act_t + 0.5 * rng.randn(3, 256)).astype(np.float32)
        states.append((totals, masks, preds, (act_p, act_t)))
    ours.reset()
    groups = np.array([0, 1, 1, 0, 2, 1])   # group 2: one image
    for g in (groups, None):
        res = ours.get_value(groups=g, states=states)
        assert_same_results(res, theirs.get_value(groups=g, states=states))
    assert res[0]['mean'] > 0 and len(res[0]) > 20
    assert np.isnan(ours.get_value(groups=groups, states=states)[1][2]['mean'])


@pytest.mark.parametrize('seed', range(4))
def test_results_table_is_pandas_text_with_class_columns(seed):
    """results_to_tsv against pandas on segm-shaped results: per-metric
    class columns in their own orders, empty cells, NaN."""
    import evaluate_predicts as bin_eval
    from lama_tpu_torch.evaluation.utils import results_to_tsv
    rng = np.random.RandomState(seed)
    names = ['mean', 'std', 'wall', 'sky', 'tree', 'person', 'car',
             'total_freq/wall', 'mask_freq/sky', 'mask_freq_diff/car']
    res = {}
    for metric in ('ssim', 'segm_stats', 'segm_ssim', 'segm_fid'):
        for group in rng.permutation(['total', '0-10%', '10-20%', '40-50%'])[
                :rng.randint(1, 4)]:
            res[(metric, str(group))] = {
                str(k): (float('nan') if rng.rand() < 0.1 else np.float32(rng.rand()))
                for k in rng.permutation(names)[:rng.randint(1, 7)]}
    buf = io.StringIO()
    bin_eval.results_to_table(res).to_csv(buf, sep='\t', float_format='%.4f')
    assert results_to_tsv(res) == buf.getvalue()


class TieBreakByPort:
    """lama_tpu's segmenter whose label, at a pixel where the port's
    differs, becomes the port's if lama_tpu's own scores for the two are
    within twice the largest score difference of the two nets (a
    near-tie); `ties` collects (near-ties, pixels) per call."""

    def __init__(self, jseg, seg, ties):
        self.jseg, self.seg, self.ties = jseg, seg, ties

    def predict(self, images, seg_size=None):
        labels, scores = (np.asarray(a) for a in self.jseg.predict(images))
        ours, our_scores = self.seg.predict(images)
        our_scores = our_scores.numpy().transpose(0, 2, 3, 1)
        tol = 2 * np.abs(our_scores - scores).max()
        assert tol <= 2 * (ATOL + RTOL * scores.max()), tol
        differ = ours != labels
        theirs_for_ours = np.take_along_axis(scores, ours[..., None], -1)[..., 0]
        assert (scores.max(-1) - theirs_for_ours <= tol)[differ].all()
        self.ties.append((int(differ.sum()), differ.size))
        return np.where(differ, ours, labels), scores


@pytest.fixture(scope='module')
def segm_setup(tmp_path_factory):
    """torch_eval_common's dataset and score nets, the same He-scaled
    mobilenetv2dilated segmenter in both packages (each package's
    SegmentationModule constructor returns it), lowrank_frechet in the FIDs,
    both packages' leave-one-out pools in process."""
    import joblib
    from lama_tpu.evaluation import fid as jfid
    from lama_tpu.evaluation import scores as jscores
    from lama_tpu.models.aux import segmentation as jseg_mod
    from lama_tpu_torch.convert import state_dict_from_flax
    from lama_tpu_torch.evaluation import scores, segm_scores
    from lama_tpu_torch.models.aux import segmentation as seg_mod
    dirs, mp = score_setup(tmp_path_factory)
    for key in ('data', 'pred'):    # four of the pairs
        sub = dirs[key] + '_4'
        os.makedirs(sub)
        for i in (0, 1, 2, 5):
            for name in ([f'img{i:02d}.png', f'img{i:02d}_mask.png']
                         if key == 'data' else [f'img{i:02d}_mask.png']):
                shutil.copy(os.path.join(dirs[key], name), sub)
        dirs[key] = sub
    arch = 'mobilenetv2dilated'
    v = random_variables(jseg_mod.SegmentationModuleNet(arch_encoder=arch),
                         jnp.zeros((1, 64, 64, 3)), seed=11, train=False)
    jseg = jseg_mod.SegmentationModule(variables=v, arch_encoder=arch)
    seg = seg_mod.SegmentationModule(
        arch_encoder=arch, device='cpu', state_dict=state_dict_from_flax(
            jax.tree.map(np.asarray, v), kind='segmentation'))
    ties = []
    mp.setattr(jseg_mod, 'SegmentationModule',
               lambda **kw: TieBreakByPort(jseg, seg, ties))
    mp.setattr(seg_mod, 'SegmentationModule', lambda **kw: seg)
    mp.setattr(joblib, 'Parallel',
               lambda n_jobs=None, **kw: lambda tasks: [f(*a, **k) for f, a, k in tasks])
    mp.setattr(segm_scores, 'leave_one_out_fids', serial_leave_one_out)
    for module in (jfid, jscores):
        mp.setattr(module, 'calculate_frechet_distance', lowrank_frechet)
    for module in (scores, segm_scores):
        mp.setattr(module, 'calculate_frechet_distance', lowrank_frechet)
    yield dict(dirs, ties=ties)
    mp.undo()


def test_evaluate_predicts_segm_matches_jax(segm_setup):
    import yaml
    import evaluate_predicts as bin_eval
    from lama_tpu_torch import evaluate_predicts
    data, pred = segm_setup['data'], segm_setup['pred']
    with open(EVAL2_SEGM) as f:
        config = yaml.safe_load(f)
    theirs = bin_eval.run_evaluation(config, data, pred, metrics=SEGM_METRICS)
    ties = np.array(segm_setup['ties']).sum(0)
    assert ties[0] <= 1e-3 * ties[1], ties
    out = os.path.join(segm_setup['root'], 'segm.tsv')
    ours = evaluate_predicts.main(evaluate_predicts.parse_args(
        [EVAL2_SEGM, data, pred, out, '--metrics', SEGM_METRICS,
         '--device', 'cpu']))
    assert list(ours) == list(theirs)
    for key, want in theirs.items():
        got = ours[key]
        assert list(got) == list(want), key
        for stat, w in want.items():
            g = got[stat]
            if np.isnan(w):
                assert np.isnan(g), (key, stat, g)
            elif key[0] == 'segm_stats':
                assert g == w, (key, stat, g, w)
            elif 'ssim' in key[0]:
                assert abs(g - w) <= 1e-6, (key, stat, g, w)
            else:
                assert abs(g - w) <= ATOL + RTOL * abs(w), (key, stat, g, w)
    total = ours[('segm_stats', 'total')]
    assert sum(v for k, v in total.items() if k.startswith('total_freq/')) \
        == pytest.approx(1, abs=1e-4)
    assert len(total) > 10 and ours[('segm_fid', 'total')]['mean'] > 0
    assert ours[('segm_ssim', 'total')]['mean'] == pytest.approx(
        ours[('ssim', 'total')]['mean'], abs=1e-6)
    buf = io.StringIO()
    bin_eval.results_to_table(ours).to_csv(buf, sep='\t', float_format='%.4f')
    with open(out) as f:
        assert f.read() == buf.getvalue()


def test_segm_config_without_metrics_runs_the_three(segm_setup, monkeypatch):
    from lama_tpu_torch import evaluate_predicts
    from lama_tpu_torch.evaluation import evaluator
    monkeypatch.setattr(evaluator.InpaintingEvaluator, 'evaluate',
                        lambda self: dict.fromkeys(self.scores))
    import yaml
    with open(EVAL2_SEGM) as f:
        config = yaml.safe_load(f)
    assert config['evaluator_kwargs']['segmentation'] is True
    names = evaluate_predicts.run_evaluation(
        config, segm_setup['data'], segm_setup['pred'], device='cpu')
    assert list(names) == ['ssim', 'lpips', 'fid']
    with pytest.raises(ValueError, match='segm_nope'):
        evaluate_predicts.run_evaluation(
            config, segm_setup['data'], segm_setup['pred'],
            metrics='ssim,segm_nope', device='cpu')
