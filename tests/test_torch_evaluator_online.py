"""The port's in-training evaluator and `python -m lama_tpu_torch.fid_score`
against lama_tpu's on the CPU, on tests/torch_eval_common.py's dataset and
shared score-net weights:
- make_evaluator(integral_kind='ssim_fid100_f1') / InpaintingEvaluatorOnline
  over two batches of four images (one in each of 8 bins), the states
  merged at the end: the same keys and values (SSIM atol 1e-6, LPIPS and
  FID rtol 1e-3 / atol 2e-4);
- fid_score between the data and prediction folders prints the FID of
  bin/fid_score.py within rtol 1e-3 / atol 2e-4, on the same image counts.
Both packages' Frechet distance is torch_eval_common.exact_frechet here
(scipy's 2048-d sqrtm takes 12-16 s on this CPU), in FIDScore and in
fid_from_activations alike.
"""
import argparse
import os
import sys

import numpy as np
import pytest
import torch

from torch_eval_common import ATOL, RTOL, assert_results_close, score_setup

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'bin'))


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    dirs, mp = score_setup(tmp_path_factory)
    yield dirs
    mp.undo()


def test_online_evaluator_matches_jax(setup):
    from lama_tpu.data.datasets import PrecomputedInpaintingResultsDataset as JD
    from lama_tpu.evaluation import make_evaluator as jmake
    from lama_tpu_torch.evaluation import make_evaluator
    ds = JD(setup['data'], setup['pred'], img_suffix='.png',
            inpainted_suffix='.png')
    items = [ds[i] for i in range(2, 10)]     # bins 0-7, one image each
    out = {}
    for name, ev in (('jax', jmake(integral_kind='ssim_fid100_f1')),
                     ('port', make_evaluator(integral_kind='ssim_fid100_f1',
                                             device='cpu'))):
        states = []
        for b in range(2):
            batch = {k: np.stack([it[k] for it in items[4 * b:4 * b + 4]])
                     for k in ('image', 'mask', 'inpainted')}
            states.append(ev.process_batch(batch))
        out[name] = ev.evaluation_end(states=states)
        assert ev.groups == []
    assert_results_close(out['port'], out['jax'])
    assert len({g for _, g in out['port']}) == 9      # total and 8 bins
    assert 0 < out['port'][('ssim_fid100_f1', 'total')]['mean'] < 1


def test_fid_score_cli_matches_bin(setup, capsys, monkeypatch):
    import fid_score as bin_fid
    from lama_tpu.evaluation import fid as jfid
    from lama_tpu_torch import fid_score
    from lama_tpu_torch.evaluation import fid
    from torch_eval_common import exact_frechet
    monkeypatch.setattr(jfid, 'calculate_frechet_distance', exact_frechet)
    monkeypatch.setattr(fid, 'calculate_frechet_distance', exact_frechet)
    bin_fid.main(argparse.Namespace(path1=setup['data'], path2=setup['pred'],
                                    batch_size=12, weights=None, device=None))
    ref = capsys.readouterr().out
    ours = fid_score.main(fid_score.parse_args(
        [setup['data'], setup['pred'], '--batch-size', '12', '--device', 'cpu']))
    out = capsys.readouterr().out
    want = float(ref.split()[1])
    assert abs(ours - want) <= ATOL + RTOL * abs(want), (ours, want)
    assert out.split('(')[1] == ref.split('(')[1]      # 24 vs 12 images
