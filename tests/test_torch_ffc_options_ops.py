"""The core ops the FFC options need, in the port against lama_tpu on the
CPU: interpolate(mode='area') shrinking (an average pool), growing and
mixed (jax.image.resize 'linear'), its refusal of other shrink factors,
erosion and dilation, and rotate by a tensor angle (its gradient in the
angle against jax.grad)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lama_tpu.ops import blur as jblur
from lama_tpu.ops import geometry as jgeo
from lama_tpu.ops import resize as jresize
from lama_tpu_torch.ops import blur, geometry, resize

torch.set_num_threads(1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1,
                                                                  2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _x(h, w, c=3, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).rand(2, h, w, c).astype(dtype)


@pytest.mark.parametrize('size,scale', [
    ((8, 8), None), ((4, 16), None), (None, 0.5), (None, 0.25),  # shrink
    ((32, 32), None), ((40, 24), None), (None, 2.0),             # grow
    ((8, 24), None), ((24, 8), None), ((5, 20), None),           # mixed
])
def test_area_matches_lama_tpu(size, scale):
    """A shrink by integer factors is an average pool; any growing axis
    makes the whole resize lama_tpu's jax.image.resize 'linear' (the
    mixed cases too: the shrinking axis is anti-aliased, not pooled)."""
    x = _x(16, 16)
    ref = jresize.interpolate(jnp.asarray(x), size=size, scale_factor=scale,
                              mode='area')
    out = resize.interpolate(nchw(x), size=size, scale_factor=scale,
                             mode='area')
    assert out.dtype == torch.float32
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_area_growth_is_not_pixel_replication():
    x = nchw(_x(4, 4))
    ours = resize.interpolate(x, size=(8, 8), mode='area')
    replicated = torch.nn.functional.interpolate(x, size=(8, 8), mode='area')
    assert float((ours - replicated).abs().max()) > 1e-2


def test_area_keeps_bf16_and_refuses_other_factors():
    x = nchw(_x(12, 12)).bfloat16()
    assert resize.interpolate(x, scale_factor=0.5, mode='area').dtype == \
        torch.bfloat16
    assert resize.interpolate(x, size=(24, 18), mode='area').dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match='integer factors'):
        resize.interpolate(x, size=(5, 5), mode='area')
    with pytest.raises(ValueError, match='unsupported'):
        resize.interpolate(x, size=(5, 5), mode='bicubic')


@pytest.mark.parametrize('k', [1, 3, 4, 5])
@pytest.mark.parametrize('op', ['erosion', 'dilation'])
def test_morphology_matches_lama_tpu(op, k):
    x = _x(11, 9, c=2, seed=k)
    ref = getattr(jblur, op)(jnp.asarray(x), k)
    out = getattr(blur, op)(nchw(x), k)
    assert out.shape == nchw(np.asarray(ref)).shape
    np.testing.assert_array_equal(nhwc(out), np.asarray(ref))


@pytest.mark.parametrize('angle', [17.5, -90.0])
def test_rotate_tensor_angle_matches_jax(angle):
    """A tensor angle gives the float angle's warp, and d sum(out * r) /
    d angle in float64 matches jax.grad's."""
    x = _x(13, 17, seed=3, dtype=np.float64)
    r = np.random.RandomState(4).rand(*x.shape)
    np.testing.assert_allclose(
        nhwc(geometry.rotate(nchw(x).float(), torch.tensor(angle))),
        nhwc(geometry.rotate(nchw(x).float(), angle)), rtol=0, atol=1e-6)
    with jax.enable_x64(True):
        ref = jax.grad(lambda a: jnp.sum(jgeo.rotate(jnp.asarray(x), a) * r))(
            jnp.asarray(angle, jnp.float64))
    a = torch.tensor([angle], dtype=torch.float64, requires_grad=True)
    (geometry.rotate(nchw(x), a) * nchw(r)).sum().backward()
    np.testing.assert_allclose(float(a.grad[0]), float(ref), rtol=1e-9)
