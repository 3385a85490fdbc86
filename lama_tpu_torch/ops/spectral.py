"""Plain 2-D real FFTs with ortho norm over NCHW tensors: the counterpart of
lama_tpu/ops/spectral.py::rfft2_dft / irfft2_dft (spectral.py:114, 131) with
float32 stores. Through torch.fft; the plain FourierUnit uses them, the
port's FourierUnit kernel does its own DFTs as matmuls."""
import torch


def rfft2(x):
    """(B, C, H, W) real -> (re, im), each (B, C, H, W//2+1) float32."""
    f = torch.fft.rfft2(x.float(), norm='ortho')
    return f.real, f.imag


def irfft2(re, im, s):
    """Inverse of `rfft2`: (B, C, H, W//2+1) re/im -> (B, C, *s) float32."""
    return torch.fft.irfft2(torch.complex(re.float(), im.float()), s=tuple(s),
                            norm='ortho')
