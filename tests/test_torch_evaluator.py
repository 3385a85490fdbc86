"""The port's offline evaluator and evaluation CLIs against lama_tpu's on
the CPU.

A tiny eval2-layout PNG dataset (12 images at 64^2, masks in all 10
mask-area bins, three in the first; perturbed predictions) is scored by
both packages with the same score-net weights (tests/torch_eval_common.py:
the JAX nets' variables, drawn with numpy, set into lama_tpu's
InceptionActivations singleton and LPIPS backbone, and carried into the
port, the VGG16 trunk through the LAMA_LPIPS_VGG_WEIGHTS file the port
reads, as lama_tpu does). Held: `python -m lama_tpu_torch.evaluate_predicts
--device cpu` (its InpaintingEvaluator) gives the keys and values of
bin/evaluate_predicts.py's run_evaluation (SSIM atol 1e-6, LPIPS and FID
rtol 1e-3 / atol 2e-4) and writes its table; the csv table is pandas' text;
the predict CLI writes the files the evaluator reads; without a card the
default device raises. FIDScore's Frechet distance is the exact
eigenvalue form in both packages (torch_eval_common.exact_frechet): the
2048-d sqrtm takes 12-16 s here.
"""
import io
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from torch_eval_common import (AREAS, ATOL, RTOL, assert_results_close,
                               score_setup)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'bin'))
EVAL2 = os.path.join(REPO, 'configs', 'eval2.yaml')


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    dirs, mp = score_setup(tmp_path_factory)
    yield dirs
    mp.undo()


@pytest.fixture(scope='module')
def jax_results(setup):
    import evaluate_predicts as bin_eval
    with open(EVAL2) as f:
        config = yaml.safe_load(f)
    return bin_eval.run_evaluation(config, setup['data'], setup['pred'])


@pytest.fixture(scope='module')
def port_run(setup):
    from lama_tpu_torch import evaluate_predicts
    out = os.path.join(setup['root'], 'port.tsv')
    results = evaluate_predicts.main(evaluate_predicts.parse_args(
        [EVAL2, setup['data'], setup['pred'], out, '--device', 'cpu']))
    return results, out


def test_offline_evaluator_matches_jax(port_run, jax_results):
    ours, _ = port_run
    assert_results_close(ours, jax_results)
    assert len({g for _, g in ours}) == 11            # total and 10 bins
    assert ours[('fid', 'total')]['mean'] > 0
    assert np.isnan(ours[('fid', '10-20%')]['mean'])   # one image in the bin
    assert ours[('fid', '0-10%')]['mean'] > 0          # three in this one
    assert ('lpips_fid100_f1', 'total') in ours


def test_evaluate_predicts_cli_writes_the_bin_table(port_run, jax_results):
    import evaluate_predicts as bin_eval
    ours, path = port_run
    buf = io.StringIO()
    bin_eval.results_to_table(jax_results).to_csv(buf, sep='\t',
                                                  float_format='%.4f')
    ref_lines = buf.getvalue().splitlines()
    with open(path) as f:
        text = f.read()
    our_lines = text.splitlines()
    assert len(our_lines) == len(ref_lines) == 2 + 11
    assert our_lines[:2] == ref_lines[:2]
    for o, r in zip(our_lines[2:], ref_lines[2:]):
        o, r = o.split('\t'), r.split('\t')
        assert o[0] == r[0] and len(o) == len(r)
        for a, b in zip(o[1:], r[1:]):
            assert (a == '') == (b == '')
            if a:
                assert abs(float(a) - float(b)) <= 1e-4 + RTOL * abs(float(b)), (o, r)
    # and the csv table is pandas' text on the port's own results
    buf = io.StringIO()
    bin_eval.results_to_table(ours).to_csv(buf, sep='\t', float_format='%.4f')
    assert text == buf.getvalue()


def test_results_to_rows_orders_as_pandas():
    """Rows by first appearance, columns metric-major, all-empty columns
    dropped, against pandas on a hand-made result with gaps."""
    import evaluate_predicts as bin_eval
    from lama_tpu_torch.evaluate_predicts import results_to_tsv
    res = {('ssim', 'total'): {'mean': 0.5, 'std': 0.1},
           ('ssim', '40-50%'): {'mean': 0.4, 'std': 0.2},
           ('ssim', '10-20%'): {'mean': -0.0, 'std': 0.0},
           ('fid', 'total'): {'mean': 12.0},
           ('fid', '10-20%'): {'mean': float('nan')},
           ('fid', '90-100%'): {'mean': 3.0},
           ('lpips', 'total'): {'std': 0.1, 'mean': 0.25}}
    buf = io.StringIO()
    bin_eval.results_to_table(res).to_csv(buf, sep='\t', float_format='%.4f')
    assert results_to_tsv(res) == buf.getvalue()


def test_predict_writes_what_the_evaluator_reads(setup, tmp_path):
    """`python -m lama_tpu_torch.predict` on the dataset (a tiny big-lama,
    random weights), then the evaluator on its output dir: every
    prediction is found, with the known pixels of its image."""
    from lama_tpu_torch import evaluate_predicts, predict
    from lama_tpu_torch.data.datasets import PrecomputedInpaintingResultsDataset
    from lama_tpu_torch.models import make_generator
    cfg = dict(kind='ffc_resnet', input_nc=4, output_nc=3, ngf=8,
               n_downsampling=2, n_blocks=1, add_out_act='sigmoid',
               init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
               downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0,
                                           enable_lfu=False),
               resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75,
                                       enable_lfu=False))
    model = tmp_path / 'model'
    (model / 'models').mkdir(parents=True)
    with open(model / 'config.yaml', 'w') as f:
        yaml.safe_dump({'generator': cfg}, f)
    kw = dict(cfg)
    torch.manual_seed(0)
    gen = make_generator(kw.pop('kind'), **kw)
    torch.save({'state_dict': {'generator.' + k: v for k, v in
                               gen.state_dict().items()}},
               model / 'models' / 'best.ckpt')
    out = tmp_path / 'out'
    predict.main([f'model.path={model}', f'indir={setup["data"]}',
                  f'outdir={out}', 'device=cpu', 'precision=fp32',
                  'dataset.img_suffix=.png'])
    ds = PrecomputedInpaintingResultsDataset(
        setup['data'], str(out), img_suffix='.png', inpainted_suffix='.png')
    assert len(ds) == len(AREAS)
    for i in range(len(ds)):
        item = ds[i]
        keep = item['mask'][..., 0] == 0
        np.testing.assert_array_equal(item['inpainted'][keep],
                                      item['image'][keep])
    res = evaluate_predicts.main(evaluate_predicts.parse_args(
        [EVAL2, setup['data'], str(out), str(tmp_path / 't.tsv'),
         '--metrics', 'ssim', '--device', 'cpu']))
    assert 0 < res[('ssim', 'total')]['mean'] < 1


@pytest.mark.parametrize('cli', ['evaluate_predicts', 'fid_score'])
def test_cuda_default_without_a_card_raises(setup, tmp_path, cli):
    import importlib
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    mod = importlib.import_module(f'lama_tpu_torch.{cli}')
    argv = ([EVAL2, setup['data'], setup['pred'], str(tmp_path / 't.tsv')]
            if cli == 'evaluate_predicts' else [setup['data'], setup['pred']])
    with pytest.raises(RuntimeError, match='device=cpu'):
        mod.main(mod.parse_args(argv))
