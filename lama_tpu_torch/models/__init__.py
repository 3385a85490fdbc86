"""Model factories (counterpart of lama_tpu/models/__init__.py:14-42); the
port has the FFC generator, the pix2pixHD GlobalGenerator, the pix2pixHD
N-layer discriminator and the FFC N-layer discriminator."""
from .ffc import FFCNLayerDiscriminator, FFCResNetGenerator
from .pix2pixhd import GlobalGenerator, NLayerDiscriminator


def make_generator(kind, serving_mode=None, **kwargs):
    """`kind` from a config's `generator:` section; the rest are the
    generator's keyword arguments (plus `dtype` and `kernels`).
    `serving_mode`: an ops/serving_mode.py ServingMode attached to the
    module tree (lama_tpu/models/__init__.py:14-20); None is the all-off
    default of training and the reference numerics."""
    if serving_mode is not None:
        kwargs['mode'] = serving_mode
    if kind == 'ffc_resnet':
        return FFCResNetGenerator(**kwargs)
    if kind == 'pix2pixhd_global':
        return GlobalGenerator(**kwargs)
    raise NotImplementedError(f'generator kind {kind!r} is not ported yet '
                              '(ROADMAP queue 1 item 12)')


def make_discriminator(kind, **kwargs):
    """`kind` from a config's `discriminator:` section; the rest are the
    discriminator's keyword arguments (plus `dtype` and `kernels`)."""
    if kind == 'pix2pixhd_nlayer':
        return NLayerDiscriminator(**kwargs)
    if kind == 'ffc_nlayer':
        return FFCNLayerDiscriminator(**kwargs)
    raise NotImplementedError(f'discriminator kind {kind!r} is not ported '
                              'yet (ROADMAP queue 1 item 12)')
