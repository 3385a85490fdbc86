"""Plain 2-D real FFTs over NCHW tensors with torch.fft's norms ('ortho',
'backward', 'forward'): the counterpart of lama_tpu/ops/spectral.py::
rfft2_dft / irfft2_dft (spectral.py:114, 131) with float32 stores. Through
torch.fft; the plain FourierUnit uses them, the port's FourierUnit kernel
does its own DFTs as matmuls. 'forward' scales as torch.fft and jnp.fft
do (1/n forward, 1 inverse), not as lama_tpu's DFT matrices, which scale it
as 'backward' (spectral.py:34, :45, :61)."""
import torch

from .precision import widen


def rfft2(x, norm='ortho'):
    """(B, C, H, W) real -> (re, im), each (B, C, H, W//2+1) float32."""
    f = torch.fft.rfft2(widen(x), norm=norm)
    return f.real, f.imag


def irfft2(re, im, s, norm='ortho'):
    """Inverse of `rfft2`: (B, C, H, W//2+1) re/im -> (B, C, *s) float32.
    The inverse DFT along H, then the inverse real DFT along W with the
    imaginary parts of its DC and (W even) Nyquist columns dropped, as
    numpy's irfft2 and the JAX package's DFT matmuls (spectral.py:131-143)
    drop them. A FourierUnit's spectrum is not Hermitian, and cuFFT's
    one-call 2-D C2R transform, which assumes it is, returns other values
    for it at some sizes (W = 128 among them, a 1024^2 refine scale's)."""
    return irfftn(re, im, s, norm)


def irfftn(re, im, s, norm='ortho'):
    """The inverse of a real FFT over the last len(s) dims: the inverse
    complex DFT over all but the last, then `irfft_w` along the last (W),
    so the imaginary parts of its DC and Nyquist columns are dropped for
    any spectrum, as numpy's irfftn drops them."""
    z = torch.fft.ifftn(torch.complex(widen(re), widen(im)), s=s[:-1],
                        dim=tuple(range(-len(s), -1)), norm=norm)
    return irfft_w(z.real, z.imag, s[-1], norm)


def irfft_w(re, im, w, norm='ortho'):
    """The inverse real DFT along W of (.., W//2+1) re/im, the imaginary
    parts of the DC and (W even) Nyquist columns dropped."""
    keep = torch.ones(re.shape[-1], dtype=re.dtype, device=re.device)
    keep[0] = 0.0
    if w % 2 == 0:
        keep[w // 2] = 0.0
    return torch.fft.irfft(torch.complex(re, im * keep), n=w, dim=-1,
                           norm=norm)
