"""Hand-written Hopper kernels, each beside its plain PyTorch version.

`reflect_conv`, `halo_conv` and `fourier_unit` wrap the CUDA sources under
`lama_tpu_torch/csrc/`, which `_build` compiles with nvcc at first use;
`conv3x3_wgmma` is the bf16 path of every 3x3 reflect conv (cols, taps and
the stride-2 down conv of `reflect_conv`, the 3x3 halo conv), and
`conv3x3_simt` the fp32 path of the 3x3 halo conv and the down conv.
`_autograd.differentiable` gives every kernel a backward pass: the VJP of
its plain version. `library` registers each kernel as an op of the
`lama_tpu_torch` namespace, which the wrappers call; importing this package
registers them.
"""
from . import library  # noqa: F401  (registers the ops the wrappers call)
