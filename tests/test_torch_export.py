"""`python -m lama_tpu_torch.export` on the CPU against bin/to_stablehlo.py,
and the registered ops (lama_tpu_torch/ops/kernels/library.py) it exports.

One model dir (tests/test_torch_serving_modes.py::make_model_dir: ngf 32,
its seeded weights crossed from lama_tpu's variables, eight convs that
quantize at the default gates) exported by both CLIs at 64 x 64:
- fp32: the port's .pt2, loaded in a fresh process that imports torch and
  the op registrations only, against lama_tpu's deserialized StableHLO
  program on the seeded input of to_stablehlo.py:112-114, at rtol 1e-3 /
  atol 2e-4 (the bounds of tests/test_export_torch_cli.py);
- int8, with dynamic scales and with calibration_indir: the CLI's own check
  against the port's eager int8 forward (< 2e-2, at bf16 compute), a
  calibrated program without an amax pass; and a calibrated int8 program
  at fp32 compute against lama_tpu's calibrated int8 serving forward within
  GEN_ATOL, the bound tests/test_torch_int8.py holds the eager int8 path
  to. At bf16 compute the two packages differ by int8's own rounding
  (ROADMAP section 3), so that bound is held at fp32 compute.
Then, on tiny random models of both generator families, the exported
graph's op calls equal the ops eager mode calls, by name; and each op's
fake tensor has the CPU implementation's shape, dtype and strides.
"""
import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jax_export
from torch.utils._python_dispatch import TorchDispatchMode

from lama_tpu_torch import export as port_export
from lama_tpu_torch.models import make_generator
from lama_tpu_torch.ops.kernels import conv_int8, library
from lama_tpu_torch.ops.kernels.fourier_unit import planar_params
from test_torch_int8 import GEN_ATOL, jax_init
from test_torch_serving_modes import GEN_CFG, make_model_dir

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
RTOL, ATOL = 1e-3, 2e-4


def _to_stablehlo():
    spec = importlib.util.spec_from_file_location(
        'bin_to_stablehlo_port_test', os.path.join(REPO, 'bin',
                                                   'to_stablehlo.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    """The port's fp32 program and its int8 programs with dynamic and
    calibrated scales; lama_tpu's fp32 program (bin/to_stablehlo.py) and
    its int8 serving forward with calibrated scales."""
    root = tmp_path_factory.mktemp('export')
    common = make_model_dir(root)
    model, indir = common[0], common[1].split('=', 1)[1]
    args = [model, 'model.checkpoint=best.ckpt', f'height={SIZE}',
            f'width={SIZE}', 'device=cpu']
    calib = [f'calibration_indir={indir}']
    out = {'root': root, 'indir': indir, 'model': model.split('=', 1)[1],
           'port': {}}
    for name, extra in (('fp32', []), ('int8', ['precision=int8']),
                        ('int8_calibrated', ['precision=int8'] + calib)):
        out['port'][name] = port_export.main(
            args + extra + [f'outdir={root / ("port_" + name)}'])
    _to_stablehlo()(args + [f'outdir={root / "jax_fp32"}'])
    blob, = (root / 'jax_fp32').iterdir()
    out['jax_fp32'] = jax_export.deserialize(blob.read_bytes())
    return out


def op_counts(graph_module):
    """Calls of each op of the port's namespace in an exported graph."""
    counts = {}
    for node in graph_module.graph.nodes:
        if (node.op == 'call_function'
                and getattr(node.target, 'namespace', None)
                == library.NAMESPACE):
            counts[node.target._opname] = counts.get(
                node.target._opname, 0) + 1
    return counts


def _seeded():
    rng = np.random.RandomState(0)
    image = rng.rand(1, SIZE, SIZE, 3).astype(np.float32)
    mask = (rng.rand(1, SIZE, SIZE, 1) > 0.8).astype(np.float32)
    return image, mask


def _run_fresh(path, image, mask, tmp):
    """The program at `path` run in a new interpreter that imports torch
    and the op registrations only; asserts that nothing of lama_tpu, jax or
    flax was loaded there."""
    np.savez(tmp / 'in.npz', image=image, mask=mask)
    code = (
        'import sys, numpy as np, torch\n'
        'import lama_tpu_torch.ops.kernels.library\n'
        f'd = np.load({str(tmp / "in.npz")!r})\n'
        f'program = torch.export.load({path!r}).module()\n'
        'out = program(torch.from_numpy(d["image"]), '
        'torch.from_numpy(d["mask"]))\n'
        f'np.save({str(tmp / "out.npy")!r}, out.detach().numpy())\n'
        'print(sorted(m for m in sys.modules if m.split(".")[0] in '
        '("lama_tpu", "jax", "flax", "jaxlib")))\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == '[]'
    return np.load(tmp / 'out.npy')


def test_fp32_program_matches_lama_tpu_in_a_fresh_process(exported,
                                                          tmp_path):
    port = exported['port']['fp32']
    assert port['path'].endswith('inpainter_64x64.pt2') and port['bytes'] > 0
    assert port['max_abs_diff'] < 1e-4
    image, mask = _seeded()
    ours = _run_fresh(port['path'], image, mask, tmp_path)
    ref = np.asarray(exported['jax_fp32'].call(jnp.asarray(image),
                                               jnp.asarray(mask)))
    assert ours.shape == ref.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    known = mask[..., 0] == 0
    np.testing.assert_array_equal(ours[known], image[known])


def _nodes(program, name):
    """The exported program's calls of op `name`."""
    return [n for n in program.graph_module.graph.nodes
            if n.op == 'call_function'
            and getattr(n.target, '_opname', None) == name]


def _program_inputs(program):
    """The graph's placeholders that the program holds (parameters,
    buffers, constants), by node name -> their fully qualified names."""
    sig = program.graph_signature
    held = {**sig.inputs_to_parameters, **sig.inputs_to_buffers,
            **sig.inputs_to_lifted_tensor_constants}
    return held


def test_int8_programs(exported):
    """Both int8 programs pass the CLI's check against the port's eager
    int8 forward and quantize each of the model's eight eligible convs;
    the calibrated one hands every quantize op and GEMM its static amax (a
    buffer of the program, no amax pass), the dynamic one runs the amax
    pass (int8_amax_quantize)."""
    dynamic, calibrated = (exported['port'][k]['path']
                           for k in ('int8', 'int8_calibrated'))
    assert dynamic.endswith('inpainter_64x64_int8.pt2')
    for name in ('int8', 'int8_calibrated'):
        assert exported['port'][name]['max_abs_diff'] < 2e-2
    program = torch.export.load(dynamic)
    counts = op_counts(program.graph_module)
    assert counts['int8_conv'] == counts['int8_amax_quantize'] == 8
    assert 'int8_quantize' not in counts
    program = torch.export.load(calibrated)
    counts = op_counts(program.graph_module)
    assert counts['int8_conv'] == counts['int8_quantize'] == 8
    assert 'int8_amax_quantize' not in counts
    held = _program_inputs(program)
    for node in _nodes(program, 'int8_quantize'):
        assert held[node.args[1].name].endswith('act_amax')
    for node in _nodes(program, 'int8_conv'):
        assert held[node.args[1].name].endswith('act_amax')
    amax = [k for k in (*program.state_dict, *program.constants)
            if k.endswith('act_amax')]
    assert len(amax) == 8, amax


@pytest.mark.parametrize('name', ['fp32', 'int8', 'int8_calibrated'])
def test_programs_hold_the_packed_weights(exported, name):
    """Every packed weight the kernels take is a constant of the program
    (freeze_for_export's buffers), not computed at each call: the
    FourierUnit's folded (W, bias) and the int8 GEMM's codes and scales
    are inputs the program holds, and the graph quantizes no weight."""
    program = torch.export.load(exported['port'][name]['path'])
    held = _program_inputs(program)
    fus = _nodes(program, 'fused_fourier_unit')
    assert fus
    for node in fus:
        assert [held[a.name].rsplit('.', 1)[1] for a in node.args[6:8]] == [
            'export_planar_weight', 'export_planar_bias']
    convs = _nodes(program, 'int8_conv')
    assert len(convs) == (0 if name == 'fp32' else 8)
    for node in convs:
        assert [held[a.name].rsplit('.', 1)[1] for a in node.args[2:4]] == [
            'export_packed_codes', 'export_packed_scales']
    targets = {str(n.target) for n in program.graph_module.graph.nodes
               if n.op == 'call_function'}
    assert not any('round' in t for t in targets), targets


def test_calibrated_int8_program_matches_lama_tpu(exported, tmp_path):
    """At fp32 compute, where tests/test_torch_int8.py holds the eager int8
    path to lama_tpu's (GEN_ATOL): the port's int8 generator, calibrated on
    the pairs bin/to_stablehlo.py:66-88 makes of the model dir's images,
    exported, saved and reloaded, against lama_tpu's int8 generator
    calibrated on the same pairs, its serving forward jitted (the function
    to_stablehlo.py exports), on the seeded input."""
    import jax
    from lama_tpu.models import make_generator as jax_make
    from lama_tpu.ops.serving_mode import ServingMode as JaxMode
    from lama_tpu.serving import calibrate_int8 as jax_calibrate
    from lama_tpu.serving import make_inpaint_forward as jax_forward
    from lama_tpu_torch.convert import load_checkpoint
    from lama_tpu_torch.ops.serving_mode import ServingMode
    from lama_tpu_torch.serving import calibrate_int8
    kw = dict(GEN_CFG)
    kind = kw.pop('kind')
    pairs = port_export.calibration_pairs(exported['indir'], '.png', SIZE,
                                          SIZE)
    gen = make_generator(kind, serving_mode=ServingMode(int8=True), **kw)
    gen.load_state_dict(load_checkpoint(os.path.join(
        exported['model'], 'models', 'best.ckpt')), strict=True)
    calibrate_int8(gen.eval(), pairs)
    path = str(tmp_path / 'int8_fp32.pt2')
    torch.export.save(port_export.export_inpainter(
        port_export.Inpainter(gen), SIZE, SIZE, 'cpu'), path)
    image, mask = _seeded()
    with torch.no_grad():
        ours = torch.export.load(path).module()(
            torch.from_numpy(image), torch.from_numpy(mask)).numpy()

    # make_model_dir's variables, served by lama_tpu's int8 generator
    variables = jax_init(jax_make(kind, **kw), np.zeros((1, SIZE, SIZE, 4),
                                                        np.float32))
    jgen = jax_make(kind, serving_mode=JaxMode(int8=True), **kw)
    calibrated = jax_calibrate(jgen, variables, pairs)
    ref = np.asarray(jax.jit(jax_forward(jgen))(calibrated, image, mask))
    fp32 = np.asarray(exported['jax_fp32'].call(image, mask))
    assert GEN_ATOL <= np.abs(ref - fp32).max() / 10     # int8 shows
    np.testing.assert_allclose(ours, ref, rtol=0, atol=GEN_ATOL)


class _CountOps(TorchDispatchMode):
    """Counts the calls of this package's ops by name."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == library.NAMESPACE:
            name = func._opname
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


FAMILIES = {   # big-lama's and big-lama-regular's widths, one block each
    'ffc_resnet': dict(input_nc=4, output_nc=3, ngf=64, n_downsampling=3,
                       n_blocks=1, add_out_act='sigmoid',
                       init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0,
                                             enable_lfu=False),
                       downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0,
                                                   enable_lfu=False),
                       resnet_conv_kwargs=dict(ratio_gin=0.75,
                                               ratio_gout=0.75,
                                               enable_lfu=True)),
    'pix2pixhd_global': dict(input_nc=4, output_nc=3, ngf=64,
                             n_downsampling=3, n_blocks=1,
                             add_out_act='sigmoid'),
}
EXPECTED = {   # per forward
    'ffc_resnet': dict(halo_conv_reflect_tiled=1, reflect_down_conv3x3=4,
                       reflect_conv3x3_cols=2, reflect_conv3x3_taps=4,
                       fused_fourier_unit=4, reflect_out_conv7x7=1),
    'pix2pixhd_global': dict(halo_conv_reflect_tiled=1,
                             halo_conv3x3_reflect=2, reflect_out_conv7x7=1),
}


@pytest.mark.parametrize('kind', sorted(FAMILIES))
def test_graph_op_counts_equal_eager(kind):
    """big-lama (with the LFU) and big-lama-regular cut to one block: the
    exported program calls each op exactly as often as eager mode does
    (each of big-lama's kernels: its stem, four downsample convs, l2l, l2g and
    g2l, the FourierUnit and the LFU, the head)."""
    torch.manual_seed(0)
    gen = make_generator(kind, **FAMILIES[kind]).eval()
    module = port_export.Inpainter(gen).eval()
    image = torch.rand(1, SIZE, SIZE, 3)
    mask = (torch.rand(1, SIZE, SIZE, 1) > 0.8).float()
    with torch.no_grad(), _CountOps() as mode:
        eager = module(image, mask)
    program = port_export.export_inpainter(module, SIZE, SIZE, 'cpu')
    assert op_counts(program.graph_module) == mode.counts
    assert mode.counts == EXPECTED[kind]
    with torch.no_grad():
        np.testing.assert_array_equal(program.module()(image, mask).numpy(),
                                      eager.numpy())


def test_export_needs_frozen_weights():
    """torch.export of a generator whose modules have not filled their
    export buffers (freeze_for_export, which export_inpainter calls)
    fails, naming the call, instead of folding the weights at every call
    of the program."""
    torch.manual_seed(0)
    gen = make_generator('ffc_resnet', **FAMILIES['ffc_resnet']).eval()
    x = torch.rand(1, 4, SIZE, SIZE)
    with torch.no_grad(), pytest.raises(Exception, match='freeze_for_export'):
        torch.export.export(gen, (x,))


def _op_cases():
    g = torch.Generator().manual_seed(5)

    def r(*shape):
        return torch.rand(*shape, generator=g)

    x16 = r(2, 128, 16, 16)
    conv_w = r(12, 8, 1, 1)
    bn = [r(12), r(12), r(12), r(12) + 0.5]
    wp, bp = planar_params(conv_w, *bn)
    xq = r(2, 64, 9, 9) - 0.5
    packed, s_w = conv_int8.pack_weight(r(32, 64, 3, 3) - 0.5)
    codes, amax = conv_int8.quantize_activation_plain(xq)
    return {
        'reflect_conv3x3_cols': (x16, r(128, 128, 3, 3), None),
        'reflect_conv3x3_taps': (x16, r(256, 128, 3, 3), r(256)),
        'reflect_down_conv3x3': (x16, r(128, 128, 3, 3), r(128)),
        'reflect_out_conv7x7': (r(1, 16, 12, 10), r(3, 16, 7, 7), r(3)),
        'halo_conv3x3_reflect': (r(1, 5, 9, 7), r(1, 5, 3, 3), r(1)),
        'halo_conv_reflect_tiled': (r(1, 4, 11, 10), r(8, 4, 7, 7), None, 2),
        'fused_fourier_unit': (r(2, 4, 8, 10).to(torch.bfloat16), conv_w,
                               *bn, wp, bp, 1e-5, True),
        'int8_amax_quantize': (xq,),
        'int8_quantize': (xq, amax),
        'int8_conv': (codes, amax, packed, s_w, r(32), 64, 32, 3, 3, [1, 1],
                      [1, 1], [1, 1], [0, 0], 'reflect', False, False,
                      torch.bfloat16),
    }


@pytest.mark.parametrize('name', sorted(library.OPS))
def test_fake_strides_equal_the_cpu_implementation(name):
    """Each op's fake tensor (register_fake: the CUDA implementation's
    layout) has the CPU implementation's shape, dtype and strides, so an
    exported graph lays tensors out as eager mode does; and opcheck passes
    (schema, fake tensor, dispatch)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    args = _op_cases()[name]
    op = getattr(torch.ops.lama_tpu_torch, name)
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
        fake = op(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    for a, b in zip(real, fake):
        assert (a.shape, a.dtype, a.stride()) == (b.shape, b.dtype,
                                                  b.stride())
    result = torch.library.opcheck(op, args, test_utils=(
        'test_schema', 'test_faketensor', 'test_aot_dispatch_dynamic'))
    assert all(v == 'SUCCESS' for v in result.values()), result
