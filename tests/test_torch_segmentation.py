"""The port's ADE20k segmenters (lama_tpu_torch/models/aux/{segmentation,
mobilenet}.py) against lama_tpu's on the CPU.

Variables are the JAX modules', drawn in numpy with He-scaled kernels and
BatchNorm statistics away from identity (torch_eval_common.random_variables:
under JAX's own init the logits collapse and every label is a near-tie),
carried into the port with state_dict_from_flax(kind='segmentation') and
loaded with strict keys. Held: PPMDeepsup and C1DeepSup (softmax at a
seg_size and log-softmax without), the MobileNetV2-dilated encoder's five
maps, and the whole SegmentationModule for both encoders at 64^2: class
scores within rtol 1e-3 / atol 2e-4, labels equal wherever lama_tpu's top
two scores differ by more than twice the largest score difference (the
near-ties, at most 1% of the pixels). Then the reference-layout files
under a TORCH_HOME-style root: their `*deepsup*` entries are dropped, the
outputs are the carried weights', a missing key raises and a lone encoder
file is ignored with a warning, as lama_tpu's rule does. Last, the seeded
random weights' BatchNorm calibration (models/aux/random_init.py), which
the card's checks of the segmenter use.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_eval_common import ATOL, RTOL, random_variables

from lama_tpu_torch.convert import state_dict_from_flax

torch.set_num_threads(1)

TIE_SHARE = 0.01    # the most of the pixels that may be near-ties


def carried(variables):
    return state_dict_from_flax(jax.tree.map(np.asarray, variables),
                                kind='segmentation')


def load(module, variables, prefix=''):
    sd = {k[len(prefix):]: v for k, v in carried(variables).items()
          if k.startswith(prefix)}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def images(n, size, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / 7.0
    out = [np.stack([np.sin(yy + i), np.cos(xx - 2 * i), np.sin(xx * yy / 9)],
                    -1) for i in range(n)]
    return np.clip(0.5 + 0.4 * np.stack(out) + 0.05 * rng.randn(n, size, size, 3),
                   0, 1).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_scores_and_labels(ours, theirs):
    """ours (B, C, H, W) tensor, theirs (B, H, W, C) array: scores close,
    labels equal outside the near-ties (top two scores closer than twice
    the largest score difference). Returns the number of near-ties."""
    ours = ours.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
    top2 = np.sort(theirs, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * np.abs(ours - theirs).max()
    assert clear.mean() >= 1 - TIE_SHARE, clear.mean()
    np.testing.assert_array_equal(ours.argmax(-1)[clear],
                                  theirs.argmax(-1)[clear])
    return int((~clear).sum())


@pytest.mark.parametrize('seg_size', [(32, 40), None])
def test_ppm_deepsup_matches_jax(seg_size):
    from lama_tpu.models.aux.segmentation import PPMDeepsup as JPPM
    from lama_tpu_torch.models.aux.segmentation import PPMDeepsup
    rng = np.random.RandomState(1)
    fmaps = [rng.randn(2, 10, 8, 96).astype(np.float32)]   # 10x8: uneven bins
    jm = JPPM(fc_dim=96)
    v = random_variables(jm, [jnp.asarray(f) for f in fmaps], seed=2)
    theirs = np.asarray(jax.jit(lambda v, f: jm.apply(v, f, seg_size=seg_size))(
        v, [jnp.asarray(f) for f in fmaps]))
    with torch.no_grad():
        ours = load(PPMDeepsup(fc_dim=96), v)([nchw(f) for f in fmaps],
                                              seg_size=seg_size)
    if seg_size is None:   # log-probabilities
        np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), theirs,
                                   rtol=RTOL, atol=ATOL)
    else:
        assert_scores_and_labels(ours, theirs)


@pytest.mark.parametrize('seg_size', [(24, 24), None])
def test_c1_deepsup_matches_jax(seg_size):
    from lama_tpu.models.aux.segmentation import C1DeepSup as JC1
    from lama_tpu_torch.models.aux.segmentation import C1DeepSup
    rng = np.random.RandomState(3)
    fmaps = [rng.randn(2, 6, 6, 320).astype(np.float32)]
    jm = JC1(fc_dim=320)
    v = random_variables(jm, [jnp.asarray(f) for f in fmaps], seed=4)
    theirs = np.asarray(jax.jit(lambda v, f: jm.apply(v, f, seg_size=seg_size))(
        v, [jnp.asarray(f) for f in fmaps]))
    with torch.no_grad():
        ours = load(C1DeepSup(fc_dim=320), v)([nchw(f) for f in fmaps],
                                               seg_size=seg_size)
    if seg_size is None:
        np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), theirs,
                                   rtol=RTOL, atol=ATOL)
    else:
        assert_scores_and_labels(ours, theirs)


def test_mobilenetv2_dilated_encoder_matches_jax():
    """The five maps (after features 2, 4, 7, 14 and the last) at 40x32:
    strides 4, 8, 8, 8, 8 after the dilate surgery."""
    from lama_tpu.models.aux.mobilenet import MobileNetV2DilatedEncoder as JM
    from lama_tpu_torch.models.aux.mobilenet import MobileNetV2DilatedEncoder
    x = images(2, 40, 5)[:, :, :32]
    jm = JM()
    v = random_variables(jm, jnp.asarray(x), seed=6)
    theirs = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = MobileNetV2DilatedEncoder()
    with torch.no_grad():
        ours = load(port, {'params': {'encoder': v['params']},
                           'batch_stats': {'encoder': v['batch_stats']}},
                    prefix='encoder.')(nchw(x))
    assert [tuple(o.shape) for o in ours] == [
        (2, 24, 10, 8), (2, 32, 5, 4), (2, 64, 5, 4), (2, 160, 5, 4),
        (2, 320, 5, 4)]
    for o, t in zip(ours, theirs):
        t = np.asarray(t)
        np.testing.assert_allclose(o.numpy().transpose(0, 2, 3, 1), t,
                                   rtol=RTOL, atol=ATOL * np.abs(t).max())
    # the surgery: dilation 2 in features 7-13, 4 from 14 on; stride 1 where
    # it was 2; the residuals decided by the stride before it
    dw = port.features[14].conv[3]
    assert (dw.stride, dw.dilation, dw.padding) == ((1, 1), (2, 2), (2, 2))
    dw = port.features[15].conv[3]
    assert (dw.stride, dw.dilation) == ((1, 1), (4, 4))
    assert not port.features[7].use_res and port.features[8].use_res


@pytest.fixture(scope='module', params=['resnet50dilated', 'mobilenetv2dilated'])
def both_modules(request):
    """lama_tpu's and the port's SegmentationModule on the same variables."""
    from lama_tpu.models.aux.segmentation import (SegmentationModule as JSeg,
                                                  SegmentationModuleNet)
    from lama_tpu_torch.models.aux.segmentation import SegmentationModule
    arch = request.param
    v = random_variables(SegmentationModuleNet(arch_encoder=arch),
                         jnp.zeros((1, 64, 64, 3)), seed=7, train=False)
    sd = carried(v)
    return arch, JSeg(variables=v, arch_encoder=arch), SegmentationModule(
        arch_encoder=arch, device='cpu', state_dict=sd), sd


def test_segmentation_module_matches_jax(both_modules):
    arch, jseg, seg, _ = both_modules
    x = images(2, 64, 8)
    j_labels, j_scores = jseg.predict(x)
    labels, scores = seg.predict(x)
    assert labels.shape == (2, 64, 64) and labels.dtype == np.int64
    assert scores.shape == (2, 150, 64, 64)
    ties = assert_scores_and_labels(scores, np.asarray(j_scores))
    clear = labels == np.asarray(j_labels)
    assert (~clear).sum() <= ties
    assert len(np.unique(labels)) > 3, np.unique(labels)   # not collapsed
    np.testing.assert_allclose(scores.sum(1).numpy(), 1, atol=1e-5)
    for ours, theirs in zip(seg.get_feature_maps(x), jseg.get_feature_maps(x)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), theirs,
                                   rtol=RTOL, atol=ATOL * np.abs(theirs).max())


def test_reference_layout_files_load(both_modules, tmp_path, caplog):
    """encoder / decoder_epoch_20.pth with the reference keys and the extra
    deep-supervision heads load under a TORCH_HOME-style root and give the
    carried weights' outputs; a missing key raises; a lone encoder file
    falls back to random weights with lama_tpu's warning."""
    from lama_tpu.models.aux.segmentation import \
        resolve_ade20k_weight_paths as jresolve
    from lama_tpu_torch.models.aux.segmentation import (
        SegmentationModule, resolve_ade20k_weight_paths)
    arch, _, seg, sd = both_modules
    root = tmp_path / 'ade20k' / f'ade20k-{arch}-ppm_deepsup'
    root.mkdir(parents=True)
    enc = {k[len('encoder.'):]: v for k, v in sd.items()
           if k.startswith('encoder.') and not k.endswith('num_batches_tracked')}
    dec = {k[len('decoder.'):]: v for k, v in sd.items()
           if k.startswith('decoder.')}
    dec['cbr_deepsup.0.weight'] = torch.zeros(4, 4, 3, 3)
    dec['conv_last_deepsup.weight'] = torch.zeros(150, 4, 1, 1)
    torch.save(enc, root / 'encoder_epoch_20.pth')
    torch.save(dec, root / 'decoder_epoch_20.pth')
    assert resolve_ade20k_weight_paths(str(tmp_path), arch) == \
        jresolve(str(tmp_path), arch) == (str(root / 'encoder_epoch_20.pth'),
                                          str(root / 'decoder_epoch_20.pth'))
    x = images(1, 32, 9)
    from_files = SegmentationModule(weights_path=str(tmp_path),
                                    arch_encoder=arch, device='cpu')
    np.testing.assert_array_equal(from_files.predict(x)[1].numpy(),
                                  seg.predict(x)[1].numpy())

    del dec[next(k for k in dec if k.endswith('conv_last.weight')
                 or k.endswith('conv_last.4.weight'))]
    torch.save(dec, root / 'decoder_epoch_20.pth')
    with pytest.raises(KeyError, match='missing'):
        SegmentationModule(weights_path=str(tmp_path), arch_encoder=arch,
                           device='cpu')

    (root / 'decoder_epoch_20.pth').unlink()
    with caplog.at_level(logging.WARNING):
        assert resolve_ade20k_weight_paths(str(tmp_path), arch) == \
            jresolve(str(tmp_path), arch) == (None, None)
        lone = SegmentationModule(weights_path=str(tmp_path),
                                  arch_encoder=arch, device='cpu')
    assert 'Partial ADE20k weights' in caplog.text
    assert 'RANDOM weights' in caplog.text
    assert not torch.equal(lone.predict(x)[1], seg.predict(x)[1])


@pytest.mark.parametrize('arch', ['resnet50dilated', 'mobilenetv2dilated'])
def test_calibrate_batchnorm_keeps_each_batchnorms_input_statistics(arch):
    """calibrate_batchnorm_ on the seeded segmenter: every BatchNorm's
    running mean and variance become the mean and unbiased variance of its
    input in the calibrating forward, the momenta are restored, the net is
    back in eval mode, and its labels hold more classes than under the
    identity statistics."""
    from lama_tpu_torch.models.aux.random_init import calibrate_batchnorm_
    from lama_tpu_torch.models.aux.segmentation import SegmentationModule
    seg = SegmentationModule(arch_encoder=arch, device='cpu')
    x = images(2, 32, 13)
    before = seg.predict(x)[0]
    seen = {}

    def keep_input(m, args):
        a = args[0].transpose(0, 1).reshape(args[0].shape[1], -1)
        seen[m] = (a.mean(1), a.var(1, unbiased=True))

    norms = [m for m in seg.net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    hooks = [m.register_forward_pre_hook(keep_input) for m in norms]
    assert calibrate_batchnorm_(seg.net, seg._input(x)) is seg.net
    for h in hooks:
        h.remove()
    assert len(seen) == len(norms) > 10 and not seg.net.training
    for m in norms:
        assert m.momentum == 0.1
        torch.testing.assert_close(m.running_mean, seen[m][0], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(m.running_var, seen[m][1], rtol=1e-4,
                                   atol=1e-6)
    assert len(np.unique(seg.predict(x)[0])) > len(np.unique(before))


@pytest.mark.parametrize('weights', [None, 'ade20k'])
@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
def test_cross_entropy_2d_matches_jax(weights, reduction):
    """losses/segmentation.py on (N, C, H, W) logits against lama_tpu's on
    (N, H, W, C), with ignore_label 255 and negative labels excluded and,
    with the ADE20k class weights, the mean over the weighted count of the
    valid pixels; labels as (N, H, W) and (N, 1, H, W)."""
    from lama_tpu.losses.segmentation import cross_entropy_2d as jce
    from lama_tpu_torch.losses.constants import weights as table
    from lama_tpu_torch.losses.segmentation import CrossEntropy2d
    from lama_tpu.losses.constants import weights as jtable
    assert table == jtable and len(table['ade20k']) == 150
    rng = np.random.RandomState(12)
    logits = (3 * rng.randn(2, 150, 6, 7)).astype(np.float32)
    target = rng.randint(0, 150, size=(2, 6, 7))
    target[0, 0, :3] = 255
    target[1, 2, 4] = -1
    want = np.asarray(jce(jnp.asarray(logits.transpose(0, 2, 3, 1)),
                          jnp.asarray(target), weights=weights,
                          reduction=reduction))
    loss = CrossEntropy2d(reduction=reduction, weights=weights)
    for t in (target, target[:, None]):
        got = loss(torch.from_numpy(logits), torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    if reduction == 'none':
        assert (want[0, 0, :3] == 0).all() and want[1, 2, 4] == 0
