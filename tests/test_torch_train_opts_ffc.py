"""The port's train step against lama_tpu's with the FFC discriminator
(ndf 8, 2 layers) and lazy R1 (`r1_every` 2 over 4 steps: the penalty,
times 2, on steps 0 and 2), the VGG19 perceptual loss (weight 1), the pps
distance weighter driving the adversarial G loss too
(`distance_weighted_mask_for_discr`) and input noise of 3 scales added into
the hole (`noise_fill_hole`); the harness and the bounds are
tests/torch_train_common.py's."""
import jax
import pytest
import torch

import torch_train_common as ttc

torch.set_num_threads(1)

GROUP = dict(disc='ffc_nlayer', r1_every=2, steps=4, vgg_weight=1.0,
             dw=dict(kind='pps', max_iters=4), dw_for_discr=True,
             noise=dict(scales=3), fill_hole=True)
REQUIRED = {'gen_pl', 'gen_adv', 'gen_fm', 'discr_real_gp'}


@pytest.fixture(scope='module')
def setup():
    return ttc.make_setup(GROUP)


@pytest.fixture(scope='module')
def fp32_sgd(setup):
    return ttc.run(setup, ttc.SGD, torch.float32)


@pytest.fixture(scope='module')
def fp64_adam(setup):
    with jax.enable_x64(True), ttc.float64_batchnorm():
        return ttc.run(setup, ttc.ADAM, torch.float64)


def test_fp32_sgd_trajectory_metrics_match_jax(fp32_sgd):
    ttc.metrics_match(fp32_sgd, REQUIRED)
    # the penalty on the steps r1_every divides, none on the others
    assert [m['discr_real_gp'] > 0 for m in fp32_sgd['port']] == \
        [True, False, True, False]


@pytest.mark.parametrize('player', [0, 1], ids=['generator', 'discriminator'])
def test_fp32_bn_running_stats_after_step_one_match_jax(fp32_sgd, player):
    ttc.stats_match(fp32_sgd, player)


def test_fp64_adam_trajectory_metrics_match_jax(fp64_adam):
    ttc.metrics_match(fp64_adam, REQUIRED)


@pytest.mark.parametrize('player', [0, 1], ids=['generator', 'discriminator'])
def test_fp64_first_step_gradients_match_jax(fp64_adam, player):
    ttc.grads_match(fp64_adam, player)
