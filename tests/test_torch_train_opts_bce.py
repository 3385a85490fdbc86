"""The port's train step against lama_tpu's with the pix2pixHD
discriminator (ndf 8, 2 layers) and the bce adversarial loss (no R1; its
mask resized to the score map, see torch_train_common._jax_adversarial),
fake fakes (probability 0.5: this run's Bernoulli draws hold both 0 and 1,
so the extra discriminator term and its BatchNorm pass are met and
skipped), the blur distance weighter (L1 and feature matching only) and
input noise of 2 scales, not added into the hole; the harness and the
bounds are tests/torch_train_common.py's."""
import jax
import pytest
import torch

import torch_train_common as ttc

torch.set_num_threads(1)

GROUP = dict(disc='pix2pixhd_nlayer', adv='bce', ff_proba=0.5,
             dw=dict(kind='blur'), noise=dict(scales=2))
REQUIRED = {'gen_adv', 'gen_fm', 'discr_adv_fake_fakes'}


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


def _both_draws(run_out):
    assert set(run_out['use_ff']) == {False, True}, run_out['use_ff']
    for used, m in zip(run_out['use_ff'], run_out['port']):
        assert (m['discr_adv_fake_fakes'] != 0) == used
        assert m['discr_real_gp'] == 0


def test_fp32_sgd_trajectory_metrics_match_jax(fp32_sgd):
    ttc.metrics_match(fp32_sgd, REQUIRED)
    _both_draws(fp32_sgd)


@pytest.mark.parametrize('player', [0, 1], ids=['generator', 'discriminator'])
def test_fp32_bn_running_stats_after_step_one_match_jax(fp32_sgd, player):
    ttc.stats_match(fp32_sgd, player)


def test_fp64_adam_trajectory_metrics_match_jax(fp64_adam):
    ttc.metrics_match(fp64_adam, REQUIRED)
    _both_draws(fp64_adam)


@pytest.mark.parametrize('player', [0, 1], ids=['generator', 'discriminator'])
def test_fp64_first_step_gradients_match_jax(fp64_adam, player):
    ttc.grads_match(fp64_adam, player)
