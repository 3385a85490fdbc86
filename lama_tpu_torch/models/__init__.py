"""Model factories (counterpart of lama_tpu/models/__init__.py:14-42), with
every kind of lama_tpu's: the generators ffc_resnet (models/ffc.py),
pix2pixhd_global and pix2pixhd_multidilated (models/pix2pixhd.py),
config_global and super_channels (models/pix2pixhd_extra.py); the
discriminators pix2pixhd_nlayer, pix2pixhd_nlayer_multidilated and
ffc_nlayer. models/multiscale.py's family has no kind, as in lama_tpu."""
from .ffc import FFCNLayerDiscriminator, FFCResNetGenerator
from .pix2pixhd import (GlobalGenerator, MultiDilatedGlobalGenerator,
                        MultidilatedNLayerDiscriminator, NLayerDiscriminator)
from .pix2pixhd_extra import (ConfigGlobalGenerator,
                              GlobalGeneratorFromSuperChannels)

GENERATORS = {'ffc_resnet': FFCResNetGenerator,
              'pix2pixhd_global': GlobalGenerator,
              'pix2pixhd_multidilated': MultiDilatedGlobalGenerator,
              'config_global': ConfigGlobalGenerator,
              'super_channels': GlobalGeneratorFromSuperChannels}
DISCRIMINATORS = {'pix2pixhd_nlayer': NLayerDiscriminator,
                  'pix2pixhd_nlayer_multidilated':
                      MultidilatedNLayerDiscriminator,
                  'ffc_nlayer': FFCNLayerDiscriminator}


def make_generator(kind, serving_mode=None, **kwargs):
    """`kind` from a config's `generator:` section; the rest are the
    generator's keyword arguments (plus `dtype` and `kernels`).
    `serving_mode`: an ops/serving_mode.py ServingMode attached to the
    module tree (lama_tpu/models/__init__.py:14-20); None is the all-off
    default of training and the reference numerics."""
    if kind not in GENERATORS:
        raise ValueError(f'Unknown generator kind {kind}')
    if serving_mode is not None:
        kwargs['mode'] = serving_mode
    return GENERATORS[kind](**kwargs)


def make_discriminator(kind, **kwargs):
    """`kind` from a config's `discriminator:` section; the rest are the
    discriminator's keyword arguments (plus `dtype` and `kernels`)."""
    if kind not in DISCRIMINATORS:
        raise ValueError(f'Unknown discriminator kind {kind}')
    return DISCRIMINATORS[kind](**kwargs)
