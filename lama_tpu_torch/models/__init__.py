"""Model factory (counterpart of lama_tpu/models/__init__.py:14-31); this
slice ports the FFC generator only."""
from .ffc import FFCResNetGenerator


def make_generator(kind, **kwargs):
    """`kind` from a config's `generator:` section; the rest are the
    generator's keyword arguments (plus `dtype` and `kernels`)."""
    if kind == 'ffc_resnet':
        return FFCResNetGenerator(**kwargs)
    raise NotImplementedError(f'generator kind {kind!r} is not ported yet '
                              '(ROADMAP queue 1 item 12)')
