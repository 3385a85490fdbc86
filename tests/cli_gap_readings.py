"""Where the int8 CLIs' gap comes from: `python -m lama_tpu_torch.predict`
and bin/predict.py on tests/test_torch_serving_modes.py's tiny model and
images, one flag set at a time.

    JAX_PLATFORMS=cpu python tests/cli_gap_readings.py

For each flag set prints the mean |d| in 8-bit levels over the holes of the
three images: the port's CLI against lama_tpu's, and each CLI against its
own fp32 serve; then, per image, the correlation of the two CLIs' headline
int8 errors, and of the port's bf16 serve's with lama_tpu's headline one.
About a minute on the CPU; writes only under a temporary directory.
"""
import os
import pathlib
import sys
import tempfile

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import test_torch_serving_modes as modes  # noqa: E402
from lama_tpu_torch import predict as port_predict  # noqa: E402

FLAG_SETS = {
    'fp32': ['precision=fp32'],
    'bf16': ['precision=bf16'],
    'bf16 spectral_bf16_store': ['precision=bf16', 'spectral_bf16_store=true'],
    'int8 (dynamic)': ['precision=int8'],
    'int8 quant_calibration=2': ['precision=int8', 'quant_calibration=2'],
    'int8 calibrated, zero_pad': ['precision=int8', 'quant_calibration=2',
                                  'quant_zero_pad=true'],
    'int8 spectral_bf16_store': ['precision=int8',
                                 'spectral_bf16_store=true'],
    'headline': modes.HEADLINE,
}


def main():
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        common = modes.make_model_dir(root)
        jax_main = modes._jax_predict()
        for i, flags in enumerate(FLAG_SETS.values()):
            jax_main(common + flags + [f'outdir={root / f"jax{i}"}'])
            port_predict.main(common + flags + [f'outdir={root / f"port{i}"}'])

        def gap(a, b):
            return np.concatenate([
                np.abs(modes._read(root, a, j) - modes._read(root, b, j))[
                    modes._hole(root, j)].ravel()
                for j in range(len(modes.SIZES))]).mean()

        def corr(a, b, j):
            hole = modes._hole(root, j)
            fp32 = modes._read(root, 'port0', j)
            return np.corrcoef((modes._read(root, a, j) - fp32)[hole].ravel(),
                               (modes._read(root, b, j) - fp32)[hole].ravel()
                               )[0, 1]

        print('flags: port vs lama_tpu | port vs its fp32 | lama_tpu vs its '
              'fp32 (mean |d|, 8-bit levels, holes)')
        for i, name in enumerate(FLAG_SETS):
            print(f'{name}: {gap(f"port{i}", f"jax{i}"):.3f} | '
                  f'{gap(f"port{i}", "port0"):.3f} | '
                  f'{gap(f"jax{i}", "jax0"):.3f}', flush=True)
        last, bf16 = len(FLAG_SETS) - 1, list(FLAG_SETS).index('bf16')
        print('correlation of the headline int8 errors (each minus the '
              "port's fp32 serve) per image: " + ', '.join(
                  f'{corr(f"port{last}", f"jax{last}", j):.3f}'
                  for j in range(len(modes.SIZES)))
              + "; the port's bf16 serve against lama_tpu's headline: "
              + ', '.join(f'{corr(f"port{bf16}", f"jax{last}", j):.3f}'
                          for j in range(len(modes.SIZES))))


if __name__ == '__main__':
    main()
