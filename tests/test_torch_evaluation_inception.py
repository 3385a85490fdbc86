"""The port's FID InceptionV3 against lama_tpu's on the CPU, with the JAX
net's variables (tests/torch_eval_common.py) carried across by
`state_dict_from_flax(kind='inception')`: every output block at
(2, 3, 299, 299), and the pooled block 3 from an odd 200x150 input through
the bilinear resize, at rtol 1e-3 / atol 2e-4; the keys are pytorch-fid's,
so its state_dict (classifier entries dropped) loads strictly; and
`InceptionActivations` gives the same (B, 2048) features.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_eval_common import (jit_apply, load_port, nchw_to_nhwc,
                               nhwc_to_nchw, random_variables)

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 2e-4


@pytest.fixture(scope='module')
def nets():
    from lama_tpu.models.aux.inception import FIDInceptionV3 as J
    from lama_tpu_torch.models.aux.inception import FIDInceptionV3 as P
    jm = J(output_blocks=(0, 1, 2, 3))
    v = random_variables(jm, jnp.zeros((1, 299, 299, 3)), seed=11, train=False)
    pm = load_port(P(output_blocks=(0, 1, 2, 3)), v, kind='inception')
    return jm, v, pm


@pytest.mark.parametrize('size', [(299, 299), (200, 150)])
def test_inception_blocks_match_jax(nets, size):
    jm, v, pm = nets
    x = np.random.RandomState(12).rand(2, *size, 3).astype(np.float32)
    want = jit_apply(jm, v, train=False)(v, x)
    with torch.no_grad():
        got = pm(nhwc_to_nchw(x))
    assert [tuple(g.shape[1:]) for g in got] == [
        (64, 73, 73), (192, 35, 35), (768, 17, 17), (2048, 1, 1)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.1   # the features keep their size
        np.testing.assert_allclose(nchw_to_nhwc(g), w, rtol=RTOL, atol=ATOL)


def test_inception_activations_match_jax(nets):
    from lama_tpu.evaluation.fid import InceptionActivations as JA
    from lama_tpu_torch.evaluation.fid import InceptionActivations
    jm, v, pm = nets
    x = np.random.RandomState(13).rand(3, 64, 80, 3).astype(np.float32)
    want = np.asarray(JA(variables=v)(x))
    ours = InceptionActivations(device='cpu', state_dict=pm.state_dict())
    got = ours(x)
    assert got.shape == (3, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pytorch_fid_state_dict_loads_strictly(nets, tmp_path):
    """The file layout of pt_inception-2015-12-05: the net's keys plus the
    classifier's (fc, AuxLogits), read from `weights_path`."""
    from lama_tpu_torch.evaluation.fid import InceptionActivations
    _, _, pm = nets
    state = dict(pm.state_dict())
    state['fc.weight'] = torch.zeros(1008, 2048)
    state['fc.bias'] = torch.zeros(1008)
    state['AuxLogits.conv0.conv.weight'] = torch.zeros(128, 768, 1, 1)
    path = tmp_path / 'pt_inception.pth'
    torch.save(state, path)
    ours = InceptionActivations(device='cpu', weights_path=str(path))
    for k, t in pm.state_dict().items():
        assert torch.equal(ours.model.state_dict()[k], t), k
    assert 'Mixed_5b.branch3x3dbl_1.conv.weight' in state
    assert 'Mixed_7c.branch_pool.bn.running_var' in state


def test_inception_singleton_per_device():
    from lama_tpu_torch.evaluation.fid import InceptionActivations
    saved = dict(InceptionActivations._instances)
    try:
        InceptionActivations._instances.clear()
        a = InceptionActivations.get(device='cpu')
        assert InceptionActivations.get(device='cpu') is a
        b = InceptionActivations(device='cpu', seed=0)
        for k, t in a.model.state_dict().items():
            assert torch.equal(b.model.state_dict()[k], t), k
    finally:
        InceptionActivations._instances.clear()
        InceptionActivations._instances.update(saved)
