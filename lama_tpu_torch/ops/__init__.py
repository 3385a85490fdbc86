"""Building blocks of the port: padding, activations, eval BatchNorm, convs
with the kernel dispatch, plain spectral transforms, resizing, gaussian
blur, and the CUDA kernels (`ops.kernels`)."""
