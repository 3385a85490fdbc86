"""The serving modes on the CPU: the FourierUnit's bf16-stored DFT stages
(spectral_bf16_store) against lama_tpu's and on the kernel's host build,
and `python -m lama_tpu_torch.predict` with int8 and every serving option
against bin/predict.py.

The CLI serves in int8 at bf16 compute, as lama_tpu's does. There the two
round their bf16 sums in other orders, and a difference of one bf16 step
in front of an int8 conv moves a code by one wherever the activation lies
near a rounding boundary. On the tiny random model below, mean |d| in
8-bit levels over the holes of the three images, the two CLIs against each
other / the port against its own fp32 serve (tests/cli_gap_readings.py):
    precision=fp32                          0.00 / -
    precision=bf16                          0.52 / 0.47
    bf16 spectral_bf16_store=true           0.51 / 0.47
    precision=int8 (dynamic scales)         2.24 / 1.90
    int8 quant_calibration=2                2.69 / 2.25
    int8 spectral_bf16_store=true           2.25 / 1.90
    the HEADLINE flags                      2.49 / 4.71
So the gap is bf16 compute's, amplified by int8's codes; the bf16 store adds
none. At bf16 compute the CLIs cannot be held within a tenth of the int8
error: even in plain bf16 they differ as much as each differs from fp32.
The CLI's holes are held by CLI_MEAN_LEVELS and by the correlation of the
two int8 errors (each CLI's int8 output minus the port's fp32 output):
0.85-0.90 per image for these flags, against -0.04-0.02 between the port's
plain bf16 serve and lama_tpu's int8 one, which a port that skipped
quantization would give. The tenth-of-the-int8-error bound is held at fp32
compute, where the two int8 generators agree within 1.1e-6
(tests/test_torch_int8.py), and the store on the unit (FU_REL).
"""
import ctypes
import importlib.util
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lama_tpu.data.io import load_image, save_image
from lama_tpu_torch import predict as port_predict
from lama_tpu_torch.convert import state_dict_from_flax
from lama_tpu_torch.models.ffc import FourierUnit
from lama_tpu_torch.ops.kernels import fourier_unit as fu
from lama_tpu_torch.ops.serving_mode import ServingMode
from lama_tpu_torch.serving import load_serving_model, make_inpaint_forward
from test_torch_int8 import jax_init

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# spectral_bf16_store: the port's unit against lama_tpu's bf16 unit, max
# |d| within 2e-2 of the largest output (lama_tpu's bf16 unit also rounds
# the DFT matrices, the spectrum and its conv to bf16, the port's keeps
# them fp32)
FU_REL = 2e-2
# the CLIs' int8 holes (see the module doc): mean |d| in 8-bit levels, and
# the least correlation of their int8 errors
CLI_MEAN_LEVELS = 3.5
CLI_MIN_CORR = 0.5


def _fu_pair(c, h, w, store, seed=0):
    """lama_tpu's bf16 FourierUnit with a mode, its variables (random BN
    statistics) and the port's unit with the same weights and mode."""
    from lama_tpu.models.ffc import FourierUnit as JaxUnit
    from lama_tpu.ops.serving_mode import ServingMode as JaxMode
    rng = np.random.RandomState(seed)
    x = rng.rand(2, h, w, c).astype(np.float32) * 2 - 1
    unit = JaxUnit(features=c, dtype=jnp.bfloat16,
                   mode=JaxMode(spectral_bf16_store=store))
    variables = unit.init(jax.random.PRNGKey(seed),
                          jnp.asarray(x, jnp.bfloat16), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables['batch_stats']['bn'] = dict(
        mean=(0.1 * rng.randn(2 * c)).astype(np.float32),
        var=(1 + 0.3 * rng.rand(2 * c)).astype(np.float32))
    port = FourierUnit(c, c, mode=ServingMode(spectral_bf16_store=store))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return unit, variables, port.eval(), x


def _port_unit(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())


def test_fourier_unit_store_bf16_matches_lama_tpu():
    unit, variables, port, x = _fu_pair(16, 16, 12, True)
    ref = np.asarray(unit.apply(variables, jnp.asarray(x, jnp.bfloat16),
                                train=False).astype(jnp.float32))
    out = _port_unit(port, x)
    assert out.dtype == torch.bfloat16
    ours = out.float().permute(0, 2, 3, 1).numpy()
    assert np.abs(ours - ref).max() <= FU_REL * np.abs(ref).max()
    # the flag changes the port's unit, as it changes lama_tpu's
    _, _, plain, _ = _fu_pair(16, 16, 12, False)
    assert not torch.equal(out, _port_unit(plain, x))


def test_fourier_unit_store_bf16_acts_only_where_lama_tpu_stores():
    """Past max(H, W) = 256 (lama_tpu's DFT path ends; its FFT path has no
    stores to round) and on fp32 input the flag changes no bit."""
    g = torch.Generator().manual_seed(0)
    c = 4
    args = [(torch.rand(2 * c, 2 * c, 1, 1, generator=g) * 2 - 1) * 0.3,
            1 + 0.2 * torch.rand(2 * c, generator=g),
            0.1 * torch.rand(2 * c, generator=g),
            0.1 * torch.rand(2 * c, generator=g),
            1 + 0.3 * torch.rand(2 * c, generator=g)]
    wide = torch.rand(1, c, 4, 260, generator=g).bfloat16()
    assert torch.equal(fu.fourier_unit_plain(wide, *args, store_bf16=True),
                       fu.fourier_unit_plain(wide, *args))
    x = torch.rand(1, c, 12, 10, generator=g)
    assert torch.equal(fu.fused_fourier_unit(x, *args, store_bf16=True),
                       fu.fused_fourier_unit(x, *args))
    stored = fu.fused_fourier_unit(x.bfloat16(), *args, store_bf16=True)
    assert stored.dtype == torch.bfloat16
    assert not torch.equal(stored.float(),
                           fu.fused_fourier_unit(x.bfloat16(), *args))


@pytest.fixture(scope='module')
def fu_host(tmp_path_factory):
    """csrc/fourier_unit.cu built on the host (as
    tests/test_torch_fourier_unit_emulated.py builds it)."""
    from test_torch_fourier_unit_emulated import host_source
    if shutil.which('g++') is None:
        pytest.skip('needs g++')
    work = tmp_path_factory.mktemp('fu_store_emu')
    with open(fu._build.source_path('fourier_unit')) as f:
        (work / 'fu_host.cpp').write_text(host_source(f.read()))
    lib = work / 'fu_host.so'
    subprocess.run(['g++', '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-I', os.path.join(REPO, 'tests'), '-o', str(lib),
                    str(work / 'fu_host.cpp')],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).lama_fu_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = fu.ARGTYPES
    return fn


@pytest.mark.parametrize('b,c,co,h,w', [
    (2, 8, 8, 8, 8),       # 16-byte runs everywhere, one tile a stage
    (1, 16, 16, 13, 11),   # odd sides, split stages on the 3-SM stand-in
    (1, 12, 20, 6, 20)])   # C % 8 != 0: the bf16 spectrum's element loads
def test_fourier_unit_store_bf16_source_on_the_host(fu_host, b, c, co, h, w):
    """The kernel's store_bf16 launches (bf16 W-DFT, H-DFT, H-iDFT and
    W-iDFT outputs; the conv stage reading the bf16 spectrum) through the
    wrapper's plan on the host build, against the plain unit rounding at
    the same four points: within 1e-2 of the largest output (a stage's
    bf16 rounding may fall the other way under another summation order)."""
    g = torch.Generator().manual_seed(b + c + h)
    x = torch.rand(b, c, h, w, generator=g).bfloat16()
    conv = (torch.rand(2 * co, 2 * c, 1, 1, generator=g) * 2 - 1) * 0.3
    bn = (1 + 0.2 * torch.rand(2 * co, generator=g),
          0.1 * torch.rand(2 * co, generator=g),
          0.1 * torch.rand(2 * co, generator=g),
          1 + 0.3 * torch.rand(2 * co, generator=g))
    wp, bp = fu.planar_params(conv, *bn)
    wf = w // 2 + 1
    spectrum = b * h * 2 * wf * max(c, co)
    xk = x.contiguous(memory_format=torch.channels_last)
    bufs = dict(x=xk, wp=wp, s0=torch.full((spectrum,), float('nan')),
                s1=torch.full((spectrum,), float('nan')).bfloat16(),
                out=torch.full((b, co, h, w), float('nan')).bfloat16()
                .contiguous(memory_format=torch.channels_last))
    launches, tabs, ws_floats = fu._launch_plan(
        b, h, w, c, co, True, torch.device('cpu'), 3, True)
    ws = torch.full((max(ws_floats, 1),), float('nan'))
    ptrs = {k: t.data_ptr() for k, t in dict(tabs, **bufs).items()}
    types = []
    for stage, dims, a, bv, o, structs, bias in launches:
        for struct, name, vec in structs:
            struct.p = ptrs[name]
            struct.vec = int(vec and ptrs[name] % 16 == 0)
        o.bias = bp.data_ptr() if bias else None
        types.append((a.bf16, bv.bf16, o.bf16))
        assert fu_host(*dims, ctypes.addressof(a), ctypes.addressof(bv),
                       ctypes.addressof(o), ws.data_ptr(), None) == 0, stage
    # bf16: x and the stored stages, and the conv stage's spectrum
    assert types == [(0, 1, 1), (0, 1, 1), (1, 0, 0), (0, 0, 1), (0, 1, 1)]
    ref = fu.fourier_unit_plain(x, conv, *bn, store_bf16=True)
    out = bufs['out']
    assert ref.dtype == torch.bfloat16 and not out.float().isnan().any()
    scale = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 1e-2 * scale


# ------------------------------------------------------------------- the CLI

GEN_CFG = dict(
    kind='ffc_resnet', input_nc=4, output_nc=3, ngf=32, n_downsampling=2,
    n_blocks=1, add_out_act='sigmoid',
    init_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    downsample_conv_kwargs=dict(ratio_gin=0, ratio_gout=0, enable_lfu=False),
    resnet_conv_kwargs=dict(ratio_gin=0.75, ratio_gout=0.75, enable_lfu=False),
)
SIZES = [(64, 64), (50, 70), (37, 45)]
HEADLINE = ['precision=int8', 'quant_calibration=2', 'quant_zero_pad=true',
            'spectral_bf16_store=true', 's2d_out_head=true',
            'xfold_stem=true']


def _jax_predict():
    spec = importlib.util.spec_from_file_location(
        'bin_predict_modes_test', os.path.join(REPO, 'bin', 'predict.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def make_model_dir(root):
    """Under `root` (a pathlib.Path): a model dir at ngf 32 (its convs from
    64 input channels and 32 outputs on quantize at the default gates: the
    second downsample, g2l, the SpectralTransform's first 1x1 conv, both
    ConvTranspose layers), with the reference init's kernels tripled and
    random BN statistics (test_torch_int8.jax_init), so int8 shows in the
    output, and three PNG pairs in
    `in/`. Returns the CLIs' common arguments."""
    from lama_tpu.models import make_generator
    from lama_tpu.training.convert import flax_to_torch
    model_dir = root / 'model'
    (model_dir / 'models').mkdir(parents=True)
    with open(model_dir / 'config.yaml', 'w') as f:
        yaml.safe_dump({'generator': GEN_CFG}, f)
    kw = dict(GEN_CFG)
    gen = make_generator(kw.pop('kind'), **kw)
    variables = jax_init(gen, np.zeros((1, 64, 64, 4), np.float32))
    sd = {f'generator.{k}': torch.from_numpy(np.ascontiguousarray(v))
          for k, v in flax_to_torch(variables, model=gen).items()}
    for k in [k for k in sd if k.endswith('.running_mean')]:
        sd[k[:-len('running_mean')] + 'num_batches_tracked'] = torch.zeros(
            (), dtype=torch.long)
    torch.save({'state_dict': sd}, model_dir / 'models' / 'best.ckpt')
    indir = root / 'in'
    indir.mkdir()
    noise = np.random.RandomState(1)
    for i, (h, w) in enumerate(SIZES):
        yy, xx = np.mgrid[0:h, 0:w] / 16.0
        img = np.stack([np.sin(yy + i), np.cos(xx), np.sin(xx + yy)], -1)
        img = np.clip(0.5 + 0.4 * img + 0.05 * noise.randn(h, w, 3), 0, 1)
        mask = np.zeros((h, w, 1))
        mask[h // 4: h // 2 + 3, w // 5: w // 2] = 1.0
        save_image(str(indir / f'img{i}.png'), img)
        save_image(str(indir / f'img{i}_mask.png'), mask)
    return [f'model.path={model_dir}', f'indir={indir}', 'device=cpu']


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """make_model_dir's model and images; both CLIs' headline int8 serves
    and the port's fp32 serve."""
    root = tmp_path_factory.mktemp('modes')
    common = make_model_dir(root)
    _jax_predict()(common + HEADLINE + [f'outdir={root / "jax"}'])
    port_predict.main(common + HEADLINE + [f'outdir={root / "port"}'])
    port_predict.main(common + ['precision=fp32', f'outdir={root / "fp32"}'])
    return root, common


def _read(root, sub, i):
    return load_image(str(root / sub / f'img{i}_mask.png'),
                      return_orig=True)[1].astype(np.int64)


def _hole(root, i):
    return load_image(str(root / 'in' / f'img{i}_mask.png'), mode='L',
                      return_orig=True)[1][..., 0] > 0


def test_int8_headline_cli_matches_bin_predict(served):
    root, _ = served
    ours_err, theirs_err, diffs = [], [], []
    for i, (h, w) in enumerate(SIZES):
        ours, theirs = _read(root, 'port', i), _read(root, 'jax', i)
        img = load_image(str(root / 'in' / f'img{i}.png'),
                         return_orig=True)[1]
        hole = _hole(root, i)
        assert ours.shape == (h, w, 3)
        np.testing.assert_array_equal(ours[~hole], img[~hole])
        np.testing.assert_array_equal(theirs[~hole], img[~hole])
        fp32 = _read(root, 'fp32', i)
        ours_err.append((ours - fp32)[hole].ravel())
        theirs_err.append((theirs - fp32)[hole].ravel())
        diffs.append(np.abs(ours - theirs)[hole].ravel())
    ours_err, theirs_err = np.concatenate(ours_err), np.concatenate(theirs_err)
    assert np.concatenate(diffs).mean() <= CLI_MEAN_LEVELS
    assert np.abs(ours_err).mean() > CLI_MEAN_LEVELS  # int8 shows
    assert np.corrcoef(ours_err, theirs_err)[0, 1] >= CLI_MIN_CORR


def test_s2d_out_head_and_xfold_stem_change_no_bit(served):
    """The port's head and stem kernels compute lama_tpu's exact rewrites
    already: with and without the two flags the files are equal."""
    root, common = served
    flags = [f for f in HEADLINE if not f.startswith(('s2d', 'xfold'))]
    port_predict.main(common + flags + [f'outdir={root / "port_noflags"}'])
    for i in range(len(SIZES)):
        np.testing.assert_array_equal(_read(root, 'port_noflags', i),
                                      _read(root, 'port', i))


@pytest.mark.parametrize('argv,match', [
    (['quant_zero_pad=true'], 'quant_zero_pad'),
    (['precision=fp32', 'spectral_bf16_store=true'], 'spectral_bf16_store'),
    (['quant_calibration=1'], 'quant_calibration'),
    (['refine=true', 'precision=int8'], 'int8')])
def test_cli_refusals_match_bin_predict(served, argv, match):
    root, common = served
    for main in (_jax_predict(), port_predict.main):
        with pytest.raises(ValueError, match=match):
            main(common + argv + [f'outdir={root / "never"}'])


def test_int8_serving_path_end_to_end(served):
    """load_serving_model(precision='int8') + make_inpaint_forward: the mode
    is the generator's attribute, known pixels are kept exactly, the holes
    stay near the fp32 serve."""
    root, _ = served
    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32))
    mask = torch.zeros(1, 64, 64, 1)
    mask[:, 16:40, 16:40] = 1.0
    outs = {}
    for precision in ('fp32', 'int8'):
        gen, _ = load_serving_model(str(root / 'model'), precision=precision,
                                    device='cpu')
        assert gen.mode.int8 == (precision == 'int8')
        outs[precision] = make_inpaint_forward(gen)(img, mask)[0].numpy()
    known = mask[0, ..., 0].numpy() == 0
    np.testing.assert_array_equal(outs['int8'][known], img[0].numpy()[known])
    hole = np.abs(outs['int8'][~known] - outs['fp32'][~known])
    assert 0 < hole.max() < 0.3 and hole.mean() < 0.05


def test_store_bf16_plan_matches_the_source():
    """With store_bf16 the plan gives the stored stages bf16 operands (the
    W-DFT, H-DFT, H-iDFT and W-iDFT outputs and their readers; the conv
    stage's A) and the conv stage the one tile height the source builds
    a bf16 A at; without it the plan is the unstored one."""
    import re
    with open(fu._build.source_path('fourier_unit')) as f:
        src = f.read()
    assert int(re.search(r'constexpr int A_BF16_BM = (\d+);', src).group(1)) \
        == fu.A_BF16_BM
    for b, h, w, c, co in ((16, 64, 64, 192, 192), (1, 6, 20, 12, 20)):
        plan = fu._stage_plan(b, h, w, c, co, True, store_bf16=True)
        assert [tuple(st['types'].values()) for st in plan] == [
            (False, True, True), (False, True, True), (True, False, False),
            (False, False, True), (False, True, True)]
        assert [st['bm'] for st in plan if st['types']['a']] == [
            fu.A_BF16_BM]
        assert [st['bm'] for st in fu._stage_plan(b, h, w, c, co, True)] == [
            fu.tile_rows(st['M'], st['N']) for st in plan]
