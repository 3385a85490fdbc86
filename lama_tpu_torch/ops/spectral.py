"""Plain 2-D real FFTs with ortho norm over NCHW tensors: the counterpart of
lama_tpu/ops/spectral.py::rfft2_dft / irfft2_dft (spectral.py:114, 131) with
float32 stores. Through torch.fft; the plain FourierUnit uses them, the
port's FourierUnit kernel does its own DFTs as matmuls."""
import torch

from .precision import widen


def rfft2(x):
    """(B, C, H, W) real -> (re, im), each (B, C, H, W//2+1) float32."""
    f = torch.fft.rfft2(widen(x), norm='ortho')
    return f.real, f.imag


def irfft2(re, im, s):
    """Inverse of `rfft2`: (B, C, H, W//2+1) re/im -> (B, C, *s) float32.
    The inverse DFT along H, then the inverse real DFT along W with the
    imaginary parts of its DC and (W even) Nyquist columns dropped, as
    numpy's irfft2 and the JAX package's DFT matmuls (spectral.py:131-143)
    drop them. A FourierUnit's spectrum is not Hermitian, and cuFFT's
    one-call 2-D C2R transform, which assumes it is, returns other values
    for it at some sizes (W = 128 among them, a 1024^2 refine scale's)."""
    h, w = s
    z = torch.fft.ifft(torch.complex(widen(re), widen(im)), n=h, dim=-2,
                       norm='ortho')
    return irfft_w(z.real, z.imag, w)


def irfft_w(re, im, w):
    """The inverse real DFT along W (ortho) of (.., W//2+1) re/im, the
    imaginary parts of the DC and (W even) Nyquist columns dropped."""
    keep = torch.ones(re.shape[-1], dtype=re.dtype, device=re.device)
    keep[0] = 0.0
    if w % 2 == 0:
        keep[w // 2] = 0.0
    return torch.fft.irfft(torch.complex(re, im * keep), n=w, dim=-1,
                           norm='ortho')
