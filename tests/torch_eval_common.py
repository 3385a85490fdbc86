"""Shared helpers of the evaluation parity tests (tests/test_torch_eval*.py):
random variables for a lama_tpu score net, made with numpy from a seed and
carried into the port's state_dict; a tiny eval2-layout dataset; both
packages' score nets set up on the same weights.

`exact_frechet` stands in for calculate_frechet_distance inside both
packages' FIDScore in the evaluator tests: scipy's sqrtm of a 2048-d
product takes 12-16 s on this CPU, an eigh of one covariance ~1 s. It
computes tr sqrtm(S1 S2) as the sum of the square roots of the
eigenvalues of L^T S2 L, S1 = L L^T (the nonzero part), which is exact for
covariances; tests/test_torch_evaluation.py holds it to the real function
(at 24-d)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lama_tpu_torch.convert import state_dict_from_flax

RTOL, ATOL = 1e-3, 2e-4


def random_variables(model, x, seed, **apply_kwargs):
    """{'params', 'batch_stats'} of a flax score net, drawn with numpy: conv
    kernels N(0, 2 / fan_in), which keep the activations' size through the
    depth (flax's torch-style init shrinks them about 6x a layer), small
    biases, and BatchNorm statistics and affine terms away from identity,
    so that each leaf's carry-over shows in the output."""
    shapes = jax.eval_shape(lambda v: model.init(jax.random.PRNGKey(0), v,
                                                 **apply_kwargs), x)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            return rng.randn(*shape).astype(np.float32) * np.sqrt(2.0 / fan_in)
        if name == 'scale':
            return (1 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == 'var':
            return (1 + 0.3 * rng.rand(*shape)).astype(np.float32)
        return (0.05 * rng.randn(*shape)).astype(np.float32)   # bias, mean

    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(
        lambda s: s, shapes, is_leaf=lambda s: hasattr(s, 'shape')))


def load_port(module, variables, kind='ffc_resnet'):
    """The port module with `variables` carried over (strict keys)."""
    sd = state_dict_from_flax(jax.tree.map(np.asarray, variables), kind=kind)
    own = module.state_dict()
    # a BatchNorm's counter has no JAX variable
    sd.update({k: v for k, v in own.items() if k not in sd
               and k.endswith('num_batches_tracked')})
    module.load_state_dict(sd, strict=True)
    return module.eval()


def nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nchw_to_nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def jit_apply(model, variables, **kwargs):
    return jax.jit(lambda v, x: model.apply(v, jnp.asarray(x), **kwargs))


# mask areas: three in the 0-10% bin, one in each other bin
AREAS = [0.02, 0.05, 0.08, 0.15, 0.25, 0.35, 0.45, 0.55, 0.65, 0.75, 0.85,
         0.95]


def write_dataset(root, seed=0, size=64):
    """eval2 layout: <data>/imgNN.png + imgNN_mask.png, and the prediction
    <pred>/imgNN_mask.png; mask NN covers AREAS[NN] of the image."""
    from lama_tpu_torch.data.io import save_image
    rng = np.random.RandomState(seed)
    data, pred = os.path.join(root, 'data'), os.path.join(root, 'pred')
    yy, xx = np.mgrid[0:size, 0:size] / 9.0
    for i, area in enumerate(AREAS):
        img = np.stack([np.sin(yy + i), np.cos(xx - i), np.sin(xx + yy)], -1)
        img = np.clip(0.5 + 0.4 * img + 0.05 * rng.randn(size, size, 3), 0, 1)
        mask = np.zeros((size, size, 1), np.float32)
        mask.reshape(-1)[:int(round(area * size * size))] = 1
        out = np.clip(img + 0.15 * rng.randn(size, size, 3) * mask, 0, 1)
        save_image(os.path.join(data, f'img{i:02d}.png'), img)
        save_image(os.path.join(data, f'img{i:02d}_mask.png'), mask)
        save_image(os.path.join(pred, f'img{i:02d}_mask.png'), out)
    return data, pred


def exact_frechet(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    w, u = np.linalg.eigh(sigma1)
    keep = w > w.max() * 1e-12
    low = u[:, keep] * np.sqrt(w[keep])
    ev = np.linalg.eigvalsh(low.T @ sigma2 @ low)
    diff = mu1 - mu2
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.sqrt(np.clip(ev, 0, None)).sum())


def lowrank_frechet(mu1, sigma1, mu2, sigma2, eps=1e-6, rank=16) -> float:
    """exact_frechet for covariances of at most `rank` + 1 samples, in a
    few matrix-vector passes at 2048-d: sigma1 = Q A Q^T on an orthonormal
    basis Q of its range (the QR of sigma1 times a fixed gaussian block), so
    the nonzero eigenvalues of sigma1 sigma2 are those of
    A^1/2 Q^T sigma2 Q A^1/2. A probe vector checks that Q holds sigma1's
    range; tests/test_torch_segm_scores.py holds it to exact_frechet."""
    rng = np.random.RandomState(0)
    q, _ = np.linalg.qr(sigma1 @ rng.randn(sigma1.shape[0], rank))
    a = q.T @ (sigma1 @ q)
    probe = sigma1 @ rng.randn(sigma1.shape[0])
    assert np.abs(q @ (q.T @ probe) - probe).max() <= 1e-9 * np.abs(probe).max()
    w, u = np.linalg.eigh(a)
    low = u * np.sqrt(np.clip(w, 0, None))
    ev = np.linalg.eigvalsh(low.T @ (q.T @ (sigma2 @ q)) @ low)
    diff = mu1 - mu2
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.sqrt(np.clip(ev, 0, None)).sum())


def score_setup(tmp_path_factory):
    """The dataset, and both packages' score nets on the same weights;
    returns its dirs and the MonkeyPatch to undo."""
    from lama_tpu.evaluation import fid as jfid
    from lama_tpu.evaluation import lpips as jlpips
    from lama_tpu.models.aux.inception import FIDInceptionV3
    from lama_tpu.models.aux.vgg import VGGFeatures
    from lama_tpu_torch.convert import state_dict_from_flax
    from lama_tpu_torch.evaluation.fid import InceptionActivations

    root = str(tmp_path_factory.mktemp('eval'))
    data, pred = write_dataset(root)
    v_inc = random_variables(FIDInceptionV3(), jnp.zeros((1, 299, 299, 3)),
                             seed=21, train=False)
    v_vgg = random_variables(VGGFeatures(), jnp.zeros((1, 64, 64, 3)), seed=22)
    vgg_path = os.path.join(root, 'vgg16.pth')
    torch.save(state_dict_from_flax(jax.tree.map(np.asarray, v_vgg)), vgg_path)
    inc_sd = state_dict_from_flax(jax.tree.map(np.asarray, v_inc),
                                  kind='inception')
    inc_sd.update({k: torch.zeros((), dtype=torch.long) for k in
                   [k[:-len('running_mean')] + 'num_batches_tracked'
                    for k in inc_sd if k.endswith('running_mean')]})

    mp = pytest.MonkeyPatch()
    from lama_tpu.evaluation import scores as jscores
    from lama_tpu_torch.evaluation import scores
    mp.setattr(jscores, 'calculate_frechet_distance', exact_frechet)
    mp.setattr(scores, 'calculate_frechet_distance', exact_frechet)
    mp.setattr(jfid.InceptionActivations, '_singleton',
               jfid.InceptionActivations(variables=v_inc))
    mp.setattr(jlpips.LPIPS, '_init_backbone', lambda self, path: v_vgg)
    mp.setattr(InceptionActivations, '_instances', {
        'cpu': InceptionActivations(device='cpu', state_dict=inc_sd)})
    mp.setenv('LAMA_LPIPS_VGG_WEIGHTS', vgg_path)
    return dict(root=root, data=data, pred=pred), mp


def assert_results_close(ours, ref):
    """Same keys in the same order; SSIM within 1e-6, the rest within
    rtol 1e-3 / atol 2e-4; NaN where the reference has NaN."""
    assert list(ours) == list(ref)
    for key, want in ref.items():
        got = ours[key]
        assert list(got) == list(want), key
        for stat, w in want.items():
            g = got[stat]
            if np.isnan(w):
                assert np.isnan(g), (key, stat, g)
            elif key[0] == 'ssim':
                assert abs(g - w) <= 1e-6, (key, stat, g, w)
            else:
                assert abs(g - w) <= ATOL + RTOL * abs(w), (key, stat, g, w)
