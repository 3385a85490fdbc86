"""The port's device CLIs on the CPU against their bin/ counterparts:
make_checkpoint, predict_inner_features, precompile, evaluator_example,
analyze_errors (with the port's own LinearSVC) and verify_reference_parity.

- make_checkpoint: the values of tests/test_cli_smoke.py:84-144 (epoch 0
  and 1 at monitor 0.5 and 0.8, weights e, EMA weights e + 10) in the
  trainer's .ckpt layout; the best epoch with the EMA preferred, the epoch
  average without it and --repair-index give bin/make_checkpoint.py's
  values, and the deployed best.ckpt serves through the predict CLI.
- predict_inner_features: the float heat maps of the same weights within
  1e-4 of lama_tpu's (capture_intermediates on model_<i>), and both CLIs'
  PNGs, of the same names, within one level.
- precompile: on the CPU it builds nothing, runs the bucket shapes, the
  score nets and refine, and refuses spatial_shards=2.
- evaluator_example: its results and printed dicts equal the JAX CLI's
  within 1e-6.
- LinearSVC: decision values against sklearn.svm.LinearSVC(dual=False)
  within 1e-4 of their range, and a whole analyze_errors run against
  bin/analyze_errors.py on the same InceptionV3 weights: the same table
  rows, pickles and files, scores within the same bound (the overlapping
  mask pairs on the port alone: bin/analyze_errors.py:150 takes float() of
  a pandas Series there, which pandas 3 refuses). sklearn's default
  tol (1e-4) stops liblinear short of the optimum of 2048-d features (its
  decision values there lie 5-10% of their range from the optimum, its
  gradient norm ~0.05); the port solves to the optimum, so where the
  features are 2048-d both are held against sklearn run to tol 1e-8.
- verify_reference_parity: one end-to-end run on seeded weights written
  with torch.save, and one with a truncated checkpoint and missing aux
  files, whose rows equal bin/verify_reference_parity.py's.
"""
import argparse
import ast
import functools
import importlib.util
import io
import json
import os
import pickle
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lama_tpu.data.io import load_image, save_image

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_CFG = dict(
    kind='ffc_resnet', input_nc=4, output_nc=3, ngf=8, n_downsampling=2,
    n_blocks=2, add_out_act='sigmoid',
    init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75,
                            enable_lfu=False))
SVM_BOUND = 1e-4   # of the decision values' range


def _bin(name):
    spec = importlib.util.spec_from_file_location(
        f'bin_{name}_cli_tools_test', os.path.join(REPO, 'bin', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_images(root, sizes, seed=0):
    rng = np.random.RandomState(seed)
    root.mkdir()
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w] / 9.0
        img = np.stack([np.sin(yy + i), np.cos(xx), np.sin(xx + yy)], -1)
        save_image(str(root / f'img{i}.png'),
                   np.clip(0.5 + 0.4 * img + 0.05 * rng.randn(h, w, 3), 0, 1))
        mask = np.zeros((h, w, 1))
        mask[h // 4:h // 2 + 3, w // 5:w // 2] = 1.0
        save_image(str(root / f'img{i}_mask.png'), mask)
    return root


@pytest.fixture(scope='module')
def model(tmp_path_factory):
    """A tiny big-lama model dir holding one set of seeded weights twice:
    lama_tpu's orbax `best` and the port's `best.ckpt`; and two PNG pairs."""
    from lama_tpu.models import make_generator
    from lama_tpu.training.checkpoint import save_pytree
    from lama_tpu.training.convert import flax_to_torch
    from test_torch_int8 import jax_init
    root = tmp_path_factory.mktemp('tools')
    model_dir = root / 'model'
    (model_dir / 'models').mkdir(parents=True)
    with open(model_dir / 'config.yaml', 'w') as f:
        yaml.safe_dump({'generator': GEN_CFG}, f)
    kw = dict(GEN_CFG)
    gen = make_generator(kw.pop('kind'), **kw)
    variables = jax_init(gen, np.zeros((1, 64, 64, 4), np.float32))
    save_pytree(str(model_dir / 'models' / 'best'), variables)
    sd = {f'generator.{k}': torch.from_numpy(np.ascontiguousarray(v))
          for k, v in flax_to_torch(variables, model=gen).items()}
    for k in [k for k in sd if k.endswith('.running_mean')]:
        sd[k[:-len('running_mean')] + 'num_batches_tracked'] = torch.zeros(
            (), dtype=torch.long)
    torch.save({'state_dict': sd}, model_dir / 'models' / 'best.ckpt')
    indir = _write_images(root / 'in', [(64, 64), (50, 70)])
    return dict(root=root, dir=model_dir, indir=indir, gen=gen,
                variables=variables)


# ------------------------------------------------------------ make_checkpoint
def _trainer_ckpt(path, e):
    """The port trainer's checkpoint layout with weights e, EMA e + 10,
    BatchNorm counters e + 5, a discriminator and optimizer states."""
    from lama_tpu_torch.models import make_generator
    kw = dict(GEN_CFG)
    gen = make_generator(kw.pop('kind'), **kw)
    sd = {}
    for k, v in gen.state_dict().items():
        sd['generator.' + k] = (torch.full_like(v, e + 5) if not
                                v.is_floating_point() else
                                torch.full_like(v, float(e)))
    for k, _ in gen.named_parameters():
        sd['generator_average.' + k] = torch.full_like(sd['generator.' + k],
                                                       e + 10.0)
    sd['discriminator.model0.weight'] = torch.zeros(2, 2)
    torch.save({'state_dict': sd, 'optimizer_states': [{}, {}],
                'global_step': e, 'epoch': e}, path)


@pytest.fixture
def runs(tmp_path):
    """tests/test_cli_smoke.py:84-105's run, in both packages' layouts."""
    from lama_tpu.training.checkpoint import save_pytree
    out = {}
    for pkg in ('jax', 'port'):
        run = tmp_path / pkg
        (run / 'models').mkdir(parents=True)
        with open(run / 'config.yaml', 'w') as f:
            yaml.safe_dump({'generator': GEN_CFG}, f)
        records = []
        for e, val in [(0, 0.5), (1, 0.8)]:
            name = f'epoch{e}' + ('.ckpt' if pkg == 'port' else '')
            if pkg == 'port':
                _trainer_ckpt(run / 'models' / name, e)
            else:
                save_pytree(str(run / 'models' / name), {
                    'g_params': {'w': np.full((2, 2), float(e), np.float32)},
                    'g_stats': {},
                    'ema_params': {'w': np.full((2, 2), float(e) + 10,
                                                np.float32)}})
            records.append({'name': name, 'epoch': e, 'value': val})
        with open(run / 'models' / 'index.json', 'w') as f:
            json.dump(records, f)
        out[pkg] = run
    return out


def _port_best(out):
    sd = torch.load(out / 'models' / 'best.ckpt', weights_only=True)
    assert list(sd) == ['state_dict']
    sd = sd['state_dict']
    assert sd and all(k.startswith('generator.') for k in sd)
    return sd


def _jax_best(out):
    import orbax.checkpoint as ocp
    return np.asarray(ocp.PyTreeCheckpointer().restore(
        str((out / 'models' / 'best').resolve()))['params']['w'])


def test_make_checkpoint_matches_bin(runs, tmp_path, model):
    from lama_tpu_torch import make_checkpoint, predict
    bin_mc = _bin('make_checkpoint')
    for tag, epochs, no_ema in (('best', None, False), ('avg', [0, 1], True)):
        jax_out, port_out = tmp_path / f'jax_{tag}', tmp_path / f'port_{tag}'
        bin_mc.main(argparse.Namespace(indir=str(runs['jax']),
                                       outdir=str(jax_out), epochs=epochs,
                                       no_ema=no_ema, device='cpu'))
        make_checkpoint.main(make_checkpoint.parse_args(
            [str(runs['port']), str(port_out)]
            + (['--epochs', '0', '1'] if epochs else [])
            + (['--no-ema'] if no_ema else [])))
        want = float(_jax_best(jax_out)[0, 0])    # 11 (EMA), then 0.5
        sd = _port_best(port_out)
        for k, v in sd.items():
            if v.is_floating_point() and 'running' not in k:
                assert torch.all(v == want), (k, v.flatten()[:2], want)
            elif not v.is_floating_point():   # counters: the first epoch's
                assert torch.all(v == (6 if tag == 'best' else 5)), k
        assert (port_out / 'config.yaml').exists()
    # a run of the model fixture's weights (the EMA copies equal): its
    # deployed checkpoint serves through the predict CLI (strict load) as
    # the model dir does
    run = tmp_path / 'run'
    (run / 'models').mkdir(parents=True)
    (run / 'config.yaml').write_text((model['dir'] / 'config.yaml')
                                     .read_text())
    sd = torch.load(model['dir'] / 'models' / 'best.ckpt',
                    weights_only=True)['state_dict']
    sd.update({'generator_average.' + k[len('generator.'):]: v
               for k, v in sd.items() if v.is_floating_point()
               and 'running' not in k},
              **{'discriminator.w': torch.zeros(1)})
    torch.save({'state_dict': sd, 'optimizer_states': [{}, {}]},
               run / 'models' / 'epoch3.ckpt')
    with open(run / 'models' / 'index.json', 'w') as f:
        json.dump([{'name': 'epoch3.ckpt', 'epoch': 3, 'value': 0.1}], f)
    make_checkpoint.main(make_checkpoint.parse_args([str(run),
                                                     str(tmp_path / 'dep')]))
    for name, path in (('served', tmp_path / 'dep'), ('model', model['dir'])):
        predict.main([f'model.path={path}', f'indir={model["indir"]}',
                      f'outdir={tmp_path / name}', 'device=cpu',
                      'precision=fp32'])
    for name in ('img0_mask.png', 'img1_mask.png'):
        np.testing.assert_array_equal(
            load_image(str(tmp_path / 'served' / name), return_orig=True)[1],
            load_image(str(tmp_path / 'model' / name), return_orig=True)[1])


@pytest.mark.parametrize('ema', [True, False])
def test_make_checkpoint_refuses_non_finite_weights(runs, tmp_path, ema):
    """A best epoch whose generator holds a NaN (in the EMA copy, or in
    the raw weights with --no-ema) fails the CLI, naming the tensor, and
    writes no best.ckpt; --epochs of a finite epoch still deploys."""
    from lama_tpu_torch import make_checkpoint
    path = runs['port'] / 'models' / 'epoch1.ckpt'
    ckpt = torch.load(path, weights_only=True)
    key = next(k for k in ckpt['state_dict']
               if k.startswith('generator_average.'))
    if not ema:
        key = 'generator.' + key[len('generator_average.'):]
    ckpt['state_dict'][key][0] = float('nan')
    torch.save(ckpt, path)
    flags = [] if ema else ['--no-ema']
    out = tmp_path / 'dep'
    with pytest.raises(ValueError, match=key.split('.', 1)[1]):
        make_checkpoint.main(make_checkpoint.parse_args(
            [str(runs['port']), str(out)] + flags))
    assert not (out / 'models' / 'best.ckpt').exists()
    make_checkpoint.main(make_checkpoint.parse_args(
        [str(runs['port']), str(out), '--epochs', '0'] + flags))
    assert not make_checkpoint.non_finite(_port_best(out))


def test_make_checkpoint_repair_index_matches_bin(runs):
    """--repair-index (outdir optional): an out-of-range record is demoted
    in place, a record without its checkpoint dropped, as the JAX CLI's."""
    from lama_tpu_torch import make_checkpoint
    summaries = {}
    for pkg, run in runs.items():
        ext = '.ckpt' if pkg == 'port' else ''
        with open(run / 'models' / 'index.json') as f:
            records = json.load(f)
        records += [{'name': f'epoch9{ext}', 'epoch': 9, 'value': 23.8},
                    {'name': f'epoch7{ext}', 'epoch': 7, 'value': 0.9}]
        if pkg == 'port':
            _trainer_ckpt(run / 'models' / 'epoch9.ckpt', 9)
        else:
            (run / 'models' / 'epoch9').mkdir()
        with open(run / 'models' / 'index.json', 'w') as f:
            json.dump(records, f)
        with open(run / 'config.yaml', 'w') as f:
            yaml.safe_dump({'generator': GEN_CFG, 'trainer': {
                'checkpoint_kwargs': {'monitor': 'val_ssim_total_mean'}}}, f)
        buf = io.StringIO()
        with redirect_stdout(buf):
            if pkg == 'port':
                make_checkpoint.main(make_checkpoint.parse_args(
                    [str(run), '--repair-index']))
            else:
                _bin('make_checkpoint').main(argparse.Namespace(
                    indir=str(run), outdir=None, epochs=None, no_ema=False,
                    device='cpu', repair_index=True))
        summaries[pkg] = buf.getvalue()
        with open(run / 'models' / 'index.json') as f:
            repaired = {r['name'][:len('epochN')]: r['value']
                        for r in json.load(f)}
        assert repaired == {'epoch0': 0.5, 'epoch1': 0.8,
                            'epoch9': float('-inf')}
    assert summaries['port'].replace('.ckpt', '').replace(
        str(runs['port']), '') == summaries['jax'].replace(
        str(runs['jax']), '')


# ----------------------------------------------------- predict_inner_features
def test_inner_features_match_bin(model, tmp_path):
    from lama_tpu_torch import predict_inner_features as pif
    from lama_tpu_torch.serving import load_serving_model
    from lama_tpu.models import make_generator as jax_make
    # the float maps: lama_tpu's capture_intermediates on model_<i> (the JAX
    # CLI's forward) against the port's hooks on model[i]
    kw = dict(GEN_CFG)
    jgen = jax_make(kw.pop('kind'), **kw)
    gen, _ = load_serving_model(str(model['dir']), precision='fp32',
                                device='cpu')
    img = load_image(str(model['indir'] / 'img0.png'))[None]
    mask = np.zeros((1, 64, 64, 1), np.float32)
    mask[:, 20:44, 20:44] = 1
    x = np.concatenate([img * (1 - mask), mask], axis=-1)
    _, state = jax.jit(functools.partial(
        jgen.apply, train=False,
        capture_intermediates=lambda mdl, name: mdl.name is not None
        and mdl.name.startswith('model_')))(model['variables'],
                                            jnp.asarray(x))
    outputs, handles = pif.capture(gen, {1, 2, 3, 4, 5, 7})
    with torch.no_grad():
        gen(torch.from_numpy(x).permute(0, 3, 1, 2))
    for h in handles:
        h.remove()
    levels = {int(n.split('_')[-1]) for n in state['intermediates']}
    assert set(outputs) == {1, 2, 3, 4, 5, 7} & levels
    for level, feats in outputs.items():
        ref = state['intermediates'][f'model_{level}']['__call__'][0]
        if isinstance(ref, tuple):
            ref = jnp.concatenate([f for f in ref if f is not None], axis=-1)
        heat = np.asarray(jnp.sqrt(jnp.mean(jnp.square(
            ref.astype(jnp.float32)), axis=-1)))[0]
        heat = heat - heat.min()
        heat = np.clip(heat / (heat.std() + 1e-8), 0, 1) * 255
        np.testing.assert_allclose(pif.heat_map(feats[0]) / 255, heat / 255,
                                   rtol=0, atol=1e-4)
    # both CLIs, on the odd-sized pair (padded to a multiple of 8)
    indir = tmp_path / 'in'
    indir.mkdir()
    for name in ('img1.png', 'img1_mask.png'):
        (indir / name).write_bytes((model['indir'] / name).read_bytes())
    common = [f'model.path={model["dir"]}', f'indir={indir}',
              'hole_radius=12', 'device=cpu']
    _bin('predict_inner_features').main(
        common + ['model.checkpoint=best', f'outdir={tmp_path / "jax"}'])
    pif.main(common + ['model.checkpoint=best.ckpt',
                       f'outdir={tmp_path / "port"}'])
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == sorted(os.listdir(tmp_path / 'port')) and len(names) == 4
    for name in names:
        a, b = (load_image(str(tmp_path / d / name), mode='L',
                           return_orig=True)[1].astype(int)
                for d in ('jax', 'port'))
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name


# ------------------------------------------------------------------ precompile
def test_precompile_on_the_cpu(model, monkeypatch):
    from lama_tpu_torch import precompile
    from lama_tpu_torch.evaluation.fid import InceptionActivations
    from lama_tpu_torch.ops.kernels import _build
    monkeypatch.setattr(_build, 'build', lambda *a, **k: pytest.fail(
        'precompile built kernels on the CPU'))
    monkeypatch.setattr(InceptionActivations, '_instances', {})
    common = [f'model.path={model["dir"]}', 'shapes=64x64,50x70',
              'batch_size=2', 'precision=fp32', 'device=cpu']
    rep = precompile.main(common + ['metrics=ssim,lpips,fid',
                                    'metrics_batches=2,1'])
    assert rep['build'] == {} and rep['refine'] == {}
    assert sorted(rep['predict']) == [(50, 70), (64, 64)]
    assert sorted(rep['metrics']) == [(50, 70, 1), (50, 70, 2), (64, 64, 1),
                                      (64, 64, 2)]
    rep = precompile.main(common + ['refine=true', 'refiner.n_iters=1'])
    assert sorted(rep['refine']) == [(50, 70), (64, 64)] and not rep['predict']
    with pytest.raises(NotImplementedError, match='item 11'):
        precompile.main(common + ['spatial_shards=2'])


# ---------------------------------------------------------- evaluator_example
def test_evaluator_example_matches_bin(monkeypatch):
    from lama_tpu.evaluation.evaluator import InpaintingEvaluator
    from lama_tpu.evaluation.scores import SSIMScore
    from lama_tpu_torch import evaluator_example
    bin_ee = _bin('evaluator_example')
    buf = io.StringIO()
    monkeypatch.setattr(sys, 'argv', ['evaluator_example.py', '--cpu'])
    with redirect_stdout(buf):
        bin_ee.main()
    theirs = buf.getvalue()
    buf = io.StringIO()
    with redirect_stdout(buf):
        ours = evaluator_example.main(['--cpu'])
    lines = [ln.split(') ', 1) for ln in buf.getvalue().splitlines()]
    ref_lines = [ln.split(') ', 1) for ln in theirs.splitlines()]
    assert [k for k, _ in lines] == [k for k, _ in ref_lines]
    for (_, a), (_, b) in zip(lines, ref_lines):
        a, b = ast.literal_eval(a), ast.literal_eval(b)
        assert a.keys() == b.keys()
        assert all(abs(a[k] - b[k]) <= 1e-6 for k in a)
    ref = InpaintingEvaluator(bin_ee.SimpleDataset(), {'ssim': SSIMScore()},
                              batch_size=4).evaluate(
        model=bin_ee.constant_fill_model)
    assert list(ours) == list(ref)
    for key in ref:
        for stat, v in ref[key].items():
            assert abs(ours[key][stat] - float(v)) <= 1e-6, (key, stat)


# -------------------------------------------------------------- the linear SVM
def _svm_sets():
    """(name, X, y, high-dimensional): seeded separable and non-separable
    sets, at few dimensions and at the InceptionV3 pool's 2048."""
    out = []
    for seed, shift, n, d in ((0, 1.0, 100, 10), (1, 0.1, 200, 20),
                              (2, 0.5, 32, 2048), (3, 0.05, 32, 2048)):
        rng = np.random.RandomState(seed)
        X = rng.randn(2 * n, d).astype(np.float32)
        X[:n] += shift
        out.append((f's{seed}', X, np.array([1] * n + [0] * n), d > n))
    return out


@pytest.mark.parametrize('case', range(4))
def test_linear_svm_matches_sklearn(case):
    import sklearn.svm
    from lama_tpu_torch.evaluation.linear_svm import LinearSVC
    _, X, y, high = _svm_sets()[case]
    ours = LinearSVC().fit(X, y)
    default = sklearn.svm.LinearSVC(dual=False).fit(X, y)
    ref = (sklearn.svm.LinearSVC(dual=False, tol=1e-8, max_iter=100000)
           .fit(X, y) if high else default)
    a, b = ours.decision_function(X), ref.decision_function(X)
    assert np.abs(a - b).max() <= SVM_BOUND * np.ptp(b)
    assert list(ours.classes_) == [0, 1]
    # the port's solution is at least as good as sklearn's default stop
    z = np.where(y == 1, 1.0, -1.0)[:, None] * ours._augment(X)
    value = ours._objective(np.append(ours.coef_[0], ours.intercept_), z)[0]
    ref_value = ours._objective(np.append(default.coef_[0],
                                          default.intercept_), z)[0]
    assert value <= ref_value * (1 + 1e-9)


# ------------------------------------------------------------- analyze_errors
@pytest.fixture
def inception(monkeypatch):
    """Both packages' InceptionV3 on one set of seeded weights."""
    from lama_tpu.evaluation import fid as jfid
    from lama_tpu.models.aux.inception import FIDInceptionV3
    from lama_tpu_torch.convert import state_dict_from_flax
    from lama_tpu_torch.evaluation.fid import InceptionActivations
    from torch_eval_common import random_variables
    v = random_variables(FIDInceptionV3(), jnp.zeros((1, 299, 299, 3)),
                         seed=21, train=False)
    sd = state_dict_from_flax(jax.tree.map(np.asarray, v), kind='inception')
    sd.update({k[:-len('running_mean')] + 'num_batches_tracked':
               torch.zeros((), dtype=torch.long)
               for k in list(sd) if k.endswith('running_mean')})
    monkeypatch.setattr(jfid.InceptionActivations, '_singleton',
                        jfid.InceptionActivations(variables=v))
    monkeypatch.setattr(InceptionActivations, '_instances', {
        'cpu': InceptionActivations(device='cpu', state_dict=sd)})


def _analyze_dirs(root):
    """Two images, two overlapping masks each, and their predictions."""
    data, pred = root / 'data', root / 'pred'
    data.mkdir()
    pred.mkdir()
    rng = np.random.RandomState(3)
    for i in range(2):
        img = rng.rand(48, 48, 3)
        save_image(str(data / f'img{i}.png'), img)
        for j, (y0, y1) in enumerate(((8, 30), (12, 34))):
            mask = np.zeros((48, 48, 1))
            mask[y0:y1, 10:36] = 1
            save_image(str(data / f'img{i}_mask{j}.png'), mask)
            save_image(str(pred / f'img{i}_mask{j}.png'),
                       np.clip(img * 0.6 + 0.2 * (j + 1) * mask, 0, 1))
    return data, pred


def test_analyze_errors_matches_bin(inception, tmp_path, monkeypatch):
    import sklearn.svm
    from lama_tpu_torch import analyze_errors
    data, pred = _analyze_dirs(tmp_path)
    config = os.path.join(REPO, 'configs', 'analyze_mask_errors.yaml')
    with open(config) as f:
        no_pairs = dict(yaml.safe_load(f), min_overlap=1.0)
    compare = str(tmp_path / 'no_pairs.yaml')
    with open(compare, 'w') as f:
        yaml.safe_dump(no_pairs, f)
    # the reference run to the optimum (see the module doc)
    monkeypatch.setattr(sklearn.svm, 'LinearSVC', functools.partial(
        sklearn.svm.LinearSVC, tol=1e-8, max_iter=100000))
    outs = {k: tmp_path / k for k in ('jax', 'port')}
    _bin('analyze_errors').main(argparse.Namespace(
        config=compare, datadir=str(data), predictdir=str(pred),
        outpath=str(outs['jax']), only_report=False, n_jobs=0,
        device='cpu'))
    analyze_errors.main(analyze_errors.parse_args(
        [compare, str(data), str(pred), str(outs['port']), '--device',
         'cpu']))

    def load(root, name):
        with open(root / 'latents' / f'{name}.pkl', 'rb') as f:
            return pickle.load(f)
    for name in ('orig_fnames', 'mask_fnames', 'mask2real_fname',
                 'mask2fake_fname'):
        assert load(outs['port'], name) == load(outs['jax'], name)
    ref = np.concatenate([load(outs['jax'], 'real_scores'),
                          load(outs['jax'], 'fake_scores')])
    ours = np.concatenate([load(outs['port'], 'real_scores'),
                           load(outs['port'], 'fake_scores')])
    bound = SVM_BOUND * np.ptp(ref)
    assert np.abs(ours - ref).max() <= bound

    def table(root):
        with open(root / 'latents' / 'join_scores_table.csv') as f:
            rows = [ln.split('\t') for ln in f.read().splitlines()]
        return rows[0], rows[1:]
    (head, rows), (ref_head, ref_rows) = table(outs['port']), table(
        outs['jax'])
    assert head == ref_head and len(rows) == len(ref_rows) == 4
    for row, ref_row in zip(rows, ref_rows):
        assert row[:3] == ref_row[:3]
        assert all(abs(float(a) - float(b)) <= bound
                   for a, b in zip(row[3:], ref_row[3:]))
    for d in ('global_best', 'global_worst'):
        assert sorted(os.listdir(outs['port'] / d)) == sorted(
            os.listdir(outs['jax'] / d))

    for root in outs.values():
        assert not (root / 'overlapping_mask_score_diffs.tsv').exists()
    # the overlapping pairs (the default min_overlap 0.5): both masks of
    # each image, their fake scores' difference
    analyze_errors.main(analyze_errors.parse_args(
        [config, str(data), str(pred), str(outs['port']), '--only-report']))
    fake = dict(zip(load(outs['port'], 'mask_fnames'),
                    load(outs['port'], 'fake_scores')))
    with open(outs['port'] / 'overlapping_mask_score_diffs.tsv') as f:
        lines = [ln.split('\t') for ln in f.read().splitlines()]
    assert sorted(os.path.basename(a) for _, a, _ in lines) == [
        'img0_mask0.png', 'img1_mask0.png']
    for d, a, b in lines:
        assert d == f'{abs(fake[a] - fake[b]):.4f}'
        assert os.path.basename(b) == os.path.basename(a).replace('0.', '1.')
    # --only-report rebuilds the same table from the pickles
    (outs['port'] / 'latents' / 'join_scores_table.csv').unlink()
    analyze_errors.main(analyze_errors.parse_args(
        [config, str(data), str(pred), str(outs['port']), '--only-report']))
    assert table(outs['port']) == (head, rows)


# --------------------------------------------------- verify_reference_parity
def _parity_weights(root, truncate=False, aux=True):
    """A weights dir in bin/verify_reference_parity.py's layout, written
    with torch.save from seeded port modules."""
    from lama_tpu_torch.models import make_generator
    from lama_tpu_torch.models.aux.inception import FIDInceptionV3
    from lama_tpu_torch.models.aux.segmentation import SegmentationModuleNet
    from lama_tpu_torch.models.aux.vgg import VGGFeatures
    root.mkdir()
    torch.manual_seed(0)
    kw = dict(GEN_CFG)
    sd = {f'generator.{k}': v for k, v in
          make_generator(kw.pop('kind'), **kw).state_dict().items()}
    if truncate:
        for k in list(sd)[:3]:
            del sd[k]
    torch.save({'state_dict': sd}, root / 'big-lama.ckpt')
    with open(root / 'generator_config.yaml', 'w') as f:
        yaml.safe_dump({'generator': GEN_CFG}, f)
    if not aux:
        return root
    torch.save(VGGFeatures().state_dict(), root / 'lpips_vgg16.pth')
    torch.save(FIDInceptionV3().state_dict(), root / 'fid_inception.pth')
    seg = SegmentationModuleNet()
    d = root / 'ade20k' / 'ade20k-resnet50dilated-ppm_deepsup'
    d.mkdir(parents=True)
    torch.save(seg.encoder.state_dict(), d / 'encoder_epoch_20.pth')
    torch.save(seg.decoder.state_dict(), d / 'decoder_epoch_20.pth')
    return root


def _parity_args(weights, data, out, expected=None, metrics='ssim'):
    from lama_tpu_torch import verify_reference_parity as vrp
    argv = ['--weights-dir', str(weights), '--datadir', str(data),
            '--outdir', str(out), '--metrics', metrics, '--batch-size', '2',
            '--device', 'cpu']
    return vrp.parse_args(argv + (['--expected', str(expected)]
                                  if expected else []))


def test_parity_harness_end_to_end(tmp_path, monkeypatch):
    from lama_tpu_torch import verify_reference_parity as vrp
    from lama_tpu_torch.evaluation import scores
    from lama_tpu_torch.evaluation.fid import InceptionActivations
    from torch_eval_common import exact_frechet
    monkeypatch.setattr(scores, 'calculate_frechet_distance', exact_frechet)
    monkeypatch.setattr(InceptionActivations, '_instances', {})
    # the harness points these at the weights it passed; undone after
    for key in ('LAMA_LPIPS_VGG_WEIGHTS', 'LAMA_FID_INCEPTION_WEIGHTS'):
        monkeypatch.setenv(key, '')
    weights = _parity_weights(tmp_path / 'weights')
    with open(tmp_path / 'expected.json', 'w') as f:
        json.dump({'ssim_total_mean': [0.5, 0.5]}, f)
    suite = _write_images(tmp_path / 'suite', [(64, 64)] * 2)
    report = vrp.main(_parity_args(weights, suite, tmp_path / 'out',
                                   tmp_path / 'expected.json',
                                   'ssim,lpips,fid'))
    for net in ('generator', 'lpips_vgg16', 'fid_inception', 'ade20k',
                'ade20k_encoder', 'ade20k_decoder'):
        assert report['nets'][net]['status'] == 'PASS', report['nets'][net]
    assert report['checks'] and report['checks'][0]['pass']
    assert report['pass'] is True
    assert 'lpips_fid100_f1_total_mean' in report['metrics']
    assert (tmp_path / 'out' / 'metrics.tsv').exists()
    assert len(list((tmp_path / 'out' / 'predictions').glob('*.png'))) == 2
    with open(tmp_path / 'out' / 'parity_report.json') as f:
        assert json.load(f)['pass'] is True


def test_parity_harness_bad_and_missing_weights_match_bin(model, tmp_path):
    """A truncated checkpoint FAILs its gate, a corrupt LPIPS file FAILs,
    the missing files SKIP, the report fails: the rows of
    bin/verify_reference_parity.py on the same dir."""
    from lama_tpu_torch import verify_reference_parity as vrp
    weights = _parity_weights(tmp_path / 'weights', truncate=True, aux=False)
    (weights / 'lpips_vgg16.pth').write_bytes(b'not a checkpoint')
    report = vrp.main(_parity_args(weights, model['indir'],
                                   tmp_path / 'out'))
    assert report['pass'] is False
    ref = _bin('verify_reference_parity').main(argparse.Namespace(
        weights_dir=str(weights), datadir=str(model['indir']),
        outdir=str(tmp_path / 'jax'), expected=None,
        config=os.path.join(REPO, 'configs', 'eval2.yaml'), metrics='ssim',
        img_suffix='.png', batch_size=1, device='cpu'))
    rows = {k: v['status'] for k, v in report['nets'].items()}
    assert rows == {k: v['status'] for k, v in ref['nets'].items()} == {
        'generator': 'FAIL', 'lpips_vgg16': 'FAIL', 'fid_inception': 'SKIP',
        'ade20k': 'SKIP'}
    assert ref['pass'] is False
    assert not (tmp_path / 'out' / 'predictions').exists()
