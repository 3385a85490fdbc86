"""One-command reference-parity campaign: `python -m
lama_tpu_torch.verify_reference_parity`, the counterpart of
bin/verify_reference_parity.py.

Usage:
  python -m lama_tpu_torch.verify_reference_parity --weights-dir W \
      --datadir D --outdir O [--expected expected.json] \
      [--metrics ssim,lpips,fid] [--device cuda|cpu]

Weights dir layout (every entry optional; a missing one is a SKIP row),
as bin/verify_reference_parity.py:15-27:
  big-lama.ckpt                the reference deployment checkpoint (any
                               single *.ckpt/*.pt/*.pth at the top level
                               works)
  generator_config.yaml        the generator kwargs (default: the big-lama
                               preset's generator node)
  lpips_vgg16.pth              torchvision VGG16 state_dict (LPIPS trunk)
  fid_inception.pth            pytorch-fid InceptionV3 state_dict
  ade20k/ade20k-resnet50dilated-ppm_deepsup/{encoder,decoder}_epoch_20.pth

The port reads the reference's weights as they are, so each gate is the
port's own strict load: the generator by convert.load_checkpoint and
load_state_dict(strict=True); the LPIPS trunk's torchvision keys
(models/aux/vgg.py::load_backbone_state, every key of VGGFeatures
present); the FID InceptionV3 by inception.fid_state_dict and a strict
load; the ADE20k pair by segmentation.load_reference_state. A gate that
raises is a FAIL row with the reason. With the generator's gate passed,
the fixed suite of --datadir is served by `python -m
lama_tpu_torch.predict` at fp32 and scored by
lama_tpu_torch.evaluate_predicts's eval2 protocol with the weights that
passed. `--expected` is a JSON {"ssim_total_mean": [value, atol], ...}
of reference numbers; each becomes a PASS/FAIL check. Writes
<outdir>/predictions/, <outdir>/metrics.tsv and
<outdir>/parity_report.json; exits 2 unless every gate and check passed.
Nothing is downloaded. device defaults to cuda and fails without a card.
"""
import argparse
import json
import logging
import os
import shutil
import sys

import torch
import yaml

from .config import compose, to_dict

LOGGER = logging.getLogger(__name__)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def find_generator_ckpt(weights_dir):
    preferred = os.path.join(weights_dir, 'big-lama.ckpt')
    if os.path.exists(preferred):
        return preferred
    for name in sorted(os.listdir(weights_dir)):
        path = os.path.join(weights_dir, name)
        if name.endswith(('.ckpt', '.pt', '.pth')) and os.path.isfile(path):
            return path
    return None


def generator_kwargs(weights_dir):
    cfg_path = os.path.join(weights_dir, 'generator_config.yaml')
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            node = yaml.safe_load(f)
        return dict(node.get('generator', node))
    cfg = compose(os.path.join(REPO, 'configs', 'training'), 'big-lama', [])
    return to_dict(cfg.generator)


def _gate(report, name, path, load):
    """Run `load(path)`: PASS with the number of tensors it returns, FAIL
    with the reason when it raises, SKIP without a file."""
    if path is None or not os.path.exists(path):
        report['nets'][name] = {'status': 'SKIP',
                                'reason': f'{path or "file"} not found'}
        return False
    try:
        n = load(path)
    except Exception as ex:   # every load error is this gate's FAIL row
        report['nets'][name] = {'status': 'FAIL', 'reason': str(ex),
                                'path': path}
        return False
    report['nets'][name] = {'status': 'PASS', 'path': path, 'tensors': n}
    return True


def _strict(module, state):
    module.load_state_dict(state, strict=True)
    return len(state)


def gate_generator(weights_dir, report):
    """The generator's strict load; (gen_kwargs, ckpt) on PASS."""
    from .convert import load_checkpoint
    from .models import make_generator
    ckpt = find_generator_ckpt(weights_dir)
    gen_kwargs = generator_kwargs(weights_dir)

    def load(path):
        kw = dict(gen_kwargs)
        return _strict(make_generator(kw.pop('kind', 'ffc_resnet'), **kw),
                       load_checkpoint(path))
    if ckpt is None:
        report['nets']['generator'] = {'status': 'SKIP',
                                       'reason': 'no .ckpt in weights dir'}
        return None, None
    if not _gate(report, 'generator', ckpt, load):
        return None, None
    return gen_kwargs, ckpt


def gate_aux_nets(weights_dir, report):
    from .models.aux.inception import FIDInceptionV3, fid_state_dict
    from .models.aux.segmentation import (SegmentationModuleNet,
                                          load_reference_state,
                                          resolve_ade20k_weight_paths)
    from .models.aux.vgg import VGGFeatures, load_backbone_state

    def vgg(path):
        model = VGGFeatures()
        state = load_backbone_state(path)
        return _strict(model, {k: v for k, v in state.items()
                               if k in model.state_dict()})

    def inception(path):
        state = torch.load(path, map_location='cpu', weights_only=True)
        if isinstance(state, dict) and 'state_dict' in state:
            state = state['state_dict']
        return _strict(FIDInceptionV3(output_blocks=(3,)),
                       fid_state_dict(state))

    _gate(report, 'lpips_vgg16', os.path.join(weights_dir, 'lpips_vgg16.pth'),
          vgg)
    _gate(report, 'fid_inception',
          os.path.join(weights_dir, 'fid_inception.pth'), inception)
    enc, dec = resolve_ade20k_weight_paths(weights_dir)
    if enc is None:
        report['nets']['ade20k'] = {
            'status': 'SKIP',
            'reason': f'encoder/decoder pair not found under {weights_dir}'}
        return
    net = SegmentationModuleNet()
    for part, path in (('encoder', enc), ('decoder', dec)):
        def load(p, part=part):
            state = torch.load(p, map_location='cpu', weights_only=True)
            load_reference_state(getattr(net, part), state)
            return len(state)
        _gate(report, f'ade20k_{part}', path, load)
    ok = all(report['nets'][f'ade20k_{p}']['status'] == 'PASS'
             for p in ('encoder', 'decoder'))
    report['nets']['ade20k'] = {'status': 'PASS' if ok else 'FAIL',
                                'path': os.path.dirname(enc)}


def serve_suite(gen_kwargs, ckpt, args):
    """The port's predict CLI at fp32 on the suite, with the checkpoint
    copied into a model dir; returns the predictions' dir."""
    from . import predict
    model_dir = os.path.join(args.outdir, 'model')
    os.makedirs(os.path.join(model_dir, 'models'), exist_ok=True)
    with open(os.path.join(model_dir, 'config.yaml'), 'w') as f:
        yaml.safe_dump({'generator': gen_kwargs,
                        'training_model': {'kind': 'default'}}, f)
    ckpt_copy = os.path.join(model_dir, 'models', 'best.ckpt')
    if not os.path.exists(ckpt_copy):
        shutil.copy(ckpt, ckpt_copy)
    predictdir = os.path.join(args.outdir, 'predictions')
    predict.main([f'model.path={model_dir}', 'model.checkpoint=best.ckpt',
                  f'indir={args.datadir}', f'outdir={predictdir}',
                  f'dataset.img_suffix={args.img_suffix}',
                  f'batch_size={args.batch_size}', 'precision=fp32',
                  f'device={args.device}'])
    return predictdir


def evaluate(report, predictdir, args):
    """The eval2 protocol with the aux weights that passed; fills
    report['metrics'] and writes metrics.tsv."""
    from .evaluate_predicts import run_evaluation
    from .evaluation.fid import InceptionActivations
    from .evaluation.utils import results_to_tsv
    from .predict import resolve_device
    if report['nets']['lpips_vgg16']['status'] == 'PASS':
        os.environ['LAMA_LPIPS_VGG_WEIGHTS'] = os.path.join(
            args.weights_dir, 'lpips_vgg16.pth')
    if report['nets']['fid_inception']['status'] == 'PASS':
        os.environ['LAMA_FID_INCEPTION_WEIGHTS'] = os.path.join(
            args.weights_dir, 'fid_inception.pth')
        # one inception a process: drop any built before the weights
        InceptionActivations._instances.clear()
    with open(args.config) as f:
        eval_config = yaml.safe_load(f)
    eval_config.setdefault('dataset_kwargs', {})['img_suffix'] = \
        args.img_suffix
    results = run_evaluation(eval_config, args.datadir, predictdir,
                             metrics=args.metrics,
                             device=resolve_device(args.device))
    table = results_to_tsv(results)
    with open(os.path.join(args.outdir, 'metrics.tsv'), 'w') as f:
        f.write(table)
    print(table, end='')
    for (metric, group), stats in results.items():
        g = group.replace('%', '').replace('-', '_')
        for stat, val in stats.items():
            report['metrics'][f'{metric}_{g}_{stat}'] = float(val)


def main(args):
    logging.basicConfig(level=logging.INFO, force=True)
    os.makedirs(args.outdir, exist_ok=True)
    report = {'weights_dir': args.weights_dir, 'nets': {}, 'metrics': {},
              'checks': [], 'pass': None}
    gen_kwargs, ckpt = gate_generator(args.weights_dir, report)
    gate_aux_nets(args.weights_dir, report)
    for name, row in report['nets'].items():
        LOGGER.info(f'gate {name}: {row["status"]}'
                    + (f' ({row.get("reason")})'
                       if row['status'] != 'PASS' else ''))
    if gen_kwargs is not None:
        evaluate(report, serve_suite(gen_kwargs, ckpt, args), args)

    ok = all(r['status'] != 'FAIL' for r in report['nets'].values())
    if args.expected:
        with open(args.expected) as f:
            expected = json.load(f)
        for key, (value, atol) in expected.items():
            measured = report['metrics'].get(key)
            passed = measured is not None and abs(measured - value) <= atol
            report['checks'].append({'metric': key, 'expected': value,
                                     'atol': atol, 'measured': measured,
                                     'pass': bool(passed)})
            ok = ok and passed
            LOGGER.info(f'check {key}: measured={measured} expected={value}'
                        f'±{atol} -> {"PASS" if passed else "FAIL"}')
    report['pass'] = bool(ok and gen_kwargs is not None)
    path = os.path.join(args.outdir, 'parity_report.json')
    with open(path, 'w') as f:
        json.dump(report, f, indent=2)
    LOGGER.info(f'parity report: {path} -> '
                f'{"PASS" if report["pass"] else "FAIL"}')
    return report


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--weights-dir', required=True)
    parser.add_argument('--datadir', required=True,
                        help='fixed suite of <name>.png + <name>_mask*.png')
    parser.add_argument('--outdir', required=True)
    parser.add_argument('--expected', default=None,
                        help='JSON {"ssim_total_mean": [value, atol], ...}')
    parser.add_argument('--config',
                        default=os.path.join(REPO, 'configs', 'eval2.yaml'))
    parser.add_argument('--metrics', default=None,
                        help='comma list: ssim,lpips,fid (default all)')
    parser.add_argument('--img-suffix', default='.png')
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    return parser.parse_args(argv)


if __name__ == '__main__':
    sys.exit(0 if main(parse_args())['pass'] else 2)
