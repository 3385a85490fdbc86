"""The compute type of the parts that the JAX package keeps in float32
(BatchNorm statistics, the spectral path, the output activation, the
losses): `widen` takes bfloat16 to float32 and leaves float32 and float64
as they are, so the port also runs whole in float64, which the CPU tests use
to hold gradients to the JAX package's far below float32 rounding."""
import torch

DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def widen(t):
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


def check_dtype(dtype):
    if dtype not in DTYPES:
        raise ValueError(f'dtype={dtype}: expected float32 or bfloat16 '
                         '(float64 for reference checks)')
    return dtype
