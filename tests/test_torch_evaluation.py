"""The port's score building blocks against lama_tpu on the CPU.

The same numpy inputs, from np.random.RandomState, go through the JAX
function and its port; the nets carry the JAX variables (drawn by
tests/torch_eval_common.py) across with `lama_tpu_torch.convert`:
- the pools (lama_tpu/ops/conv.py:338-370 and the InceptionV3's 'same'
  pools), exactly; the global mean of adaptive_avg_pool2d within float32
  rounding (its sum runs in another order than XLA's reduction);
- SSIM (evaluation/ssim.py), atol 1e-6;
- the VGG16 trunk's LPIPS taps and LPIPS for net vgg, alex and squeeze,
  rtol 1e-3 / atol 2e-4, at a size where each tap has a few pixels;
- calculate_frechet_distance on the same activations: equal;
- the carried LPIPS heads: byte copies of the JAX package's.
"""
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_eval_common import (jit_apply, load_port, nchw_to_nhwc,
                               nhwc_to_nchw, random_variables)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-3, 2e-4


@pytest.mark.parametrize('name', ['avg2', 'max2', 'max3s2', 'adaptive_div',
                                  'avg_same', 'max_same'])
def test_pools_match_jax_exactly(name):
    from lama_tpu.models.aux import inception as jinc
    from lama_tpu.ops import conv as jconv
    from lama_tpu_torch.ops import pool
    x = np.random.RandomState(0).randn(2, 13, 10, 5).astype(np.float32)
    if name == 'adaptive_div':
        x = x[:, :12]
    cases = {
        'avg2': (lambda a: jconv.avg_pool2d(a, 2, 2), lambda t: pool.avg_pool2d(t, 2, 2)),
        'max2': (lambda a: jconv.max_pool2d(a, 2, 2), lambda t: pool.max_pool2d(t, 2, 2)),
        'max3s2': (lambda a: jconv.max_pool2d(a, 3, 2), lambda t: pool.max_pool2d(t, 3, 2)),
        'adaptive_div': (lambda a: jconv.adaptive_avg_pool2d(a, (6, 5)),
                         lambda t: pool.adaptive_avg_pool2d(t, (6, 5))),
        'avg_same': (jinc.avg_pool_3x3_same_exclude_pad,
                     pool.avg_pool_3x3_same_exclude_pad),
        'max_same': (jinc.max_pool_3x3_same, pool.max_pool_3x3_same),
    }
    jfn, pfn = cases[name]
    want = np.asarray(jfn(jnp.asarray(x)))
    got = nchw_to_nhwc(pfn(nhwc_to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape', [(2, 13, 10, 5), (2, 17, 17, 64),
                                   (2, 8, 8, 2048)])
def test_global_pool_matches_jax(shape):
    from lama_tpu.ops import conv as jconv
    from lama_tpu_torch.ops import pool
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jconv.adaptive_avg_pool2d(jnp.asarray(x), 1))
    got = nchw_to_nhwc(pool.adaptive_avg_pool2d(nhwc_to_nchw(x), 1))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * np.spacing(np.abs(want).max()))


@pytest.mark.parametrize('size', [(32, 32), (23, 41)])
def test_ssim_matches_jax(size):
    from lama_tpu.evaluation.ssim import ssim as jssim
    from lama_tpu_torch.evaluation.ssim import ssim
    rng = np.random.RandomState(1)
    a = rng.rand(3, *size, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    b[0] = a[0]                                  # the identity case
    b[1, :, :size[1] // 2] = 0.5                 # a flat region
    want = np.asarray(jssim(jnp.asarray(b), jnp.asarray(a)))
    got = ssim(nhwc_to_nchw(b), nhwc_to_nchw(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert abs(got[0] - 1) < 1e-6
    mean = ssim(nhwc_to_nchw(b), nhwc_to_nchw(a), size_average=True)
    np.testing.assert_allclose(float(mean), float(want.mean()), atol=1e-6)


def test_vgg16_taps_match_jax():
    from lama_tpu.models.aux.vgg import VGGFeatures as J
    from lama_tpu_torch.models.aux.vgg import VGGFeatures as P
    x = np.random.RandomState(2).rand(2, 48, 40, 3).astype(np.float32)
    jm = J()
    v = random_variables(jm, jnp.zeros((1, 48, 40, 3)), seed=3)
    want = jit_apply(jm, v)(v, x)
    pm = load_port(P(), v)
    with torch.no_grad():
        got = pm(nhwc_to_nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(nchw_to_nhwc(g), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def test_vgg_keys_are_torchvision_features():
    from lama_tpu_torch.models.aux.vgg import VGGFeatures
    keys = set(VGGFeatures().state_dict())
    convs = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    assert keys == {f'features.{i}.{p}' for i in convs
                    for p in ('weight', 'bias')}


@pytest.mark.parametrize('net,size', [('vgg', (48, 40)), ('alex', (96, 80)),
                                      ('squeeze', (64, 72))])
def test_lpips_matches_jax(net, size):
    from lama_tpu.evaluation.lpips import LPIPS as JL
    from lama_tpu_torch.evaluation.lpips import LPIPS
    rng = np.random.RandomState(4)
    a = rng.rand(3, *size, 3).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    b[2] = a[2]
    port = LPIPS(net=net)
    jmodel = JL(backbone_variables={}, net=net).model
    v = random_variables(jmodel, jnp.zeros((1, *size, 3)), seed=5)
    jl = JL(backbone_variables=v, net=net)
    want = np.asarray(jl(jnp.asarray(b), jnp.asarray(a)))
    load_port(port.model, v)
    with torch.no_grad():
        got = port(nhwc_to_nchw(b), nhwc_to_nchw(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[2] == 0 and (got[:2] > 0).all()


def test_lpips_heads_are_byte_copies():
    src = os.path.join(REPO, 'lama_tpu', 'resources', 'lpips_lin')
    dst = os.path.join(REPO, 'lama_tpu_torch', 'resources', 'lpips_lin')
    for net in ('vgg', 'alex', 'squeeze'):
        assert filecmp.cmp(os.path.join(src, f'{net}.npz'),
                           os.path.join(dst, f'{net}.npz'), shallow=False)


def test_lpips_loads_a_torchvision_backbone_file(tmp_path):
    """A torchvision vgg16 state_dict (features.* and classifier.*) loads
    into the backbone; without a file the weights come from the seed."""
    from lama_tpu_torch.evaluation.lpips import LPIPS
    a = LPIPS(seed=7)
    state = dict(a.model.state_dict())
    state['classifier.0.weight'] = torch.zeros(2, 2)
    torch.save(state, tmp_path / 'vgg16.pth')
    b = LPIPS(backbone_weights_path=str(tmp_path / 'vgg16.pth'))
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k])
    c = LPIPS(seed=8)
    assert not torch.equal(c.model.features[0].weight,
                           a.model.features[0].weight)
    assert torch.equal(LPIPS(seed=7).model.features[0].weight,
                       a.model.features[0].weight)


def test_frechet_distance_equals_jax():
    from lama_tpu.evaluation import fid as jfid
    from lama_tpu_torch.evaluation import fid
    rng = np.random.RandomState(6)
    a = rng.randn(40, 16)
    b = 0.5 * rng.randn(40, 16) + 0.3
    assert fid.fid_from_activations(a, b) == jfid.fid_from_activations(a, b)
    mu, sig = a.mean(0), np.cov(a, rowvar=False)
    low = np.cov(a[:5], rowvar=False)            # rank 4 of 16: singular
    assert fid.calculate_frechet_distance(mu, sig, mu, low) == \
        jfid.calculate_frechet_distance(mu, sig, mu, low)
    assert abs(fid.fid_from_activations(a, a)) < 1e-6


@pytest.mark.parametrize('n', [5, 40])
def test_exact_frechet_stand_in_equals_the_real_one(n):
    """The evaluator tests' stand-in for the sqrtm (tests/torch_eval_common.py)
    gives the real function's value, on rank-deficient (5 samples) and full
    (40 samples) 24-d covariances."""
    from torch_eval_common import exact_frechet
    from lama_tpu_torch.evaluation.fid import calculate_frechet_distance
    rng = np.random.RandomState(n)
    a, b = rng.randn(n, 24), 0.7 * rng.randn(n, 24) + 0.2
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0),
            np.cov(b, rowvar=False))
    want = calculate_frechet_distance(*args)
    assert abs(exact_frechet(*args) - want) <= 1e-6 * abs(want)


def test_seeded_random_init_is_deterministic_and_scaled():
    from lama_tpu_torch.models.aux.random_init import seeded_random_init_
    from lama_tpu_torch.models.aux.small_nets import AlexNetFeatures
    a = seeded_random_init_(AlexNetFeatures(), seed=3)
    b = seeded_random_init_(AlexNetFeatures(), seed=3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.features[3].weight.detach()
    assert abs(float(w.std()) - (2.0 / w[0].numel()) ** 0.5) < 0.05 * float(w.std())
    assert float(a.features[3].bias.abs().max()) == 0


def test_port_state_dict_keys_cover_the_jax_variables():
    """Every JAX variable of each score net lands on a port key, and every
    port key but the BatchNorm counters has one."""
    from lama_tpu.models.aux import small_nets as js
    from lama_tpu_torch.convert import state_dict_from_flax
    from lama_tpu_torch.models.aux import small_nets as ps
    import jax
    for jcls, pcls, size in ((js.AlexNetFeatures, ps.AlexNetFeatures, 96),
                             (js.SqueezeNetFeatures, ps.SqueezeNetFeatures, 64)):
        v = random_variables(jcls(), jnp.zeros((1, size, size, 3)), seed=0)
        sd = state_dict_from_flax(jax.tree.map(np.asarray, v))
        assert set(sd) == set(pcls().state_dict())
