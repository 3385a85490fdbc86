"""Model factories (counterpart of lama_tpu/models/__init__.py:14-42); the
port has the FFC generator, the pix2pixHD GlobalGenerator, the pix2pixHD
N-layer discriminator and the FFC N-layer discriminator."""
from .ffc import FFCNLayerDiscriminator, FFCResNetGenerator
from .pix2pixhd import GlobalGenerator, NLayerDiscriminator


def make_generator(kind, **kwargs):
    """`kind` from a config's `generator:` section; the rest are the
    generator's keyword arguments (plus `dtype` and `kernels`)."""
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
