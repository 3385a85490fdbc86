"""COUNTLESS 2x label-map downsampling (a copy of
lama_tpu/evaluation/countless.py; W. Silversmith's algorithm, which the
reference vendors at evaluation/masks/countless/ and uses as
`zero_corrected_countless` for segmentation maps, mask.py:226).

2x2 majority without counting: a pixel that matches any other in the block
wins, else D. The zero-corrected variant offsets labels by +1 so label 0 is
handled correctly. Host numpy, used during mask synthesis.
"""
import numpy as np


def _upgrade_type(data):
    dt = data.dtype
    if dt == np.uint8:
        return data.astype(np.uint16), True
    if dt == np.uint16:
        return data.astype(np.uint32), True
    if dt == np.uint32:
        return data.astype(np.uint64), True
    return data, False


def zero_corrected_countless(data: np.ndarray) -> np.ndarray:
    """Downsample a 2-D label array by 2 on each side. Even dims required."""
    assert data.ndim == 2 and data.shape[0] % 2 == 0 and data.shape[1] % 2 == 0, data.shape
    data, upgraded = _upgrade_type(data)
    data = data + 1  # make 0 participate in the matching logic

    a = data[0::2, 0::2]
    b = data[0::2, 1::2]
    c = data[1::2, 0::2]
    d = data[1::2, 1::2]

    ab = a * (a == b)
    ac = a * (a == c)
    bc = b * (b == c)
    winner = ab | ac | bc
    result = winner + (winner == 0) * d - 1

    if upgraded:
        return result.astype(_DOWNGRADE[result.dtype])
    return result


_DOWNGRADE = {np.dtype(np.uint16): np.uint8,
              np.dtype(np.uint32): np.uint16,
              np.dtype(np.uint64): np.uint32}


def countless3d(data: np.ndarray) -> np.ndarray:
    """3-D 2×2×2 mode downsampling (the vendored countless3d.py's dynamic
    majority algorithm, simplified to an exact block mode — the inpainting
    pipeline itself only uses the 2-D variant). Even dims required."""
    assert data.ndim == 3 and all(s % 2 == 0 for s in data.shape), data.shape
    z, y, x = data.shape
    blocks = data.reshape(z // 2, 2, y // 2, 2, x // 2, 2)
    blocks = blocks.transpose(0, 2, 4, 1, 3, 5).reshape(z // 2, y // 2, x // 2, 8)
    # exact mode per block; ties resolved to the smallest label (deterministic)
    out = np.empty(blocks.shape[:3], dtype=data.dtype)
    flat = blocks.reshape(-1, 8)
    sorted_vals = np.sort(flat, axis=1)
    best_count = np.ones(flat.shape[0], dtype=np.int8)
    best_val = sorted_vals[:, 0].copy()
    run_val = sorted_vals[:, 0].copy()
    run_count = np.ones(flat.shape[0], dtype=np.int8)
    for k in range(1, 8):
        same = sorted_vals[:, k] == run_val
        run_count = np.where(same, run_count + 1, 1)
        run_val = sorted_vals[:, k]
        better = run_count > best_count
        best_count = np.where(better, run_count, best_count)
        best_val = np.where(better, run_val, best_val)
    out.ravel()[:] = best_val
    return out


def countless(data: np.ndarray) -> np.ndarray:
    """Raw COUNTLESS (incorrect when 0 labels are present — kept for parity
    with the vendored module's API)."""
    assert data.ndim == 2 and data.shape[0] % 2 == 0 and data.shape[1] % 2 == 0
    data, upgraded = _upgrade_type(data)
    data = data + 1
    a = data[0::2, 0::2]
    b = data[0::2, 1::2]
    c = data[1::2, 0::2]
    d = data[1::2, 1::2]
    ab_ac = a * ((a == b) | (a == c))
    ab_ac |= b * (b == c)
    result = ab_ac + (ab_ac == 0) * d - 1
    if upgraded:
        return result.astype(_DOWNGRADE[result.dtype])
    return result
