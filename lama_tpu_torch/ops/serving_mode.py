"""The serving configuration of a generator: int8 convs, their zero-padded
border, bf16-stored spectral stages and the two exact conv rewrites.

A copy of lama_tpu/ops/serving_mode.py (ServingMode :23-80, its checks
:65-72 and `but`). As there, the mode is an attribute of the module tree
(threaded from `models.make_generator` to every conv and FourierUnit), so
two models served in other modes coexist in one process with no ambient
state.

int8: eligible convs (`ops/quant.py::conv_eligible`) run an int8 x int8 ->
    int32 contraction, per-output-channel weight scales and one activation
    scale per tensor (ops/kernels/conv_int8.py).
zero_pad: inside the quantized convs, a reflect or replicate border is
    treated as zeros (requires int8).
spectral_bf16_store: the FourierUnit's four DFT stage outputs are rounded
    to bf16 and stored so (ops/kernels/fourier_unit.py `store_bf16`); only
    when the unit's input is bf16 and max(H, W) <= 256, as in lama_tpu.
s2d: 'off' | 'out_head' | 'all'. lama_tpu's space-to-depth rewrite of the
    thin-output 7x7 head (ops/s2d_conv.py), exact, taken only off the CPU
    (lama_tpu/ops/conv.py:226-258).
xfold_stem: lama_tpu's kx-tap channel fold of the thin-input 7x7 stem,
    exact, taken only off the CPU (lama_tpu/ops/conv.py:226-236).
    The port's head and stem kernels (kernels 5 and 7) already compute
    exactly those functions on the card, so `s2d` and `xfold_stem` are
    accepted and carried here and select no other code path.
calibrating: the calibration pass (serving.py::calibrate_int8): each
    eligible conv records the max |input| it sees in its `act_amax` buffer.
min_contraction_channels / min_out_channels: the int8 eligibility gates,
    lowered by tests of tiny models.
"""
from dataclasses import dataclass, replace as _dc_replace


@dataclass(frozen=True)
class ServingMode:
    int8: bool = False
    zero_pad: bool = False
    spectral_bf16_store: bool = False
    s2d: str = 'off'
    xfold_stem: bool = False
    calibrating: bool = False
    min_contraction_channels: int = 64
    min_out_channels: int = 32

    def __post_init__(self):
        if self.s2d not in ('off', 'out_head', 'all'):
            raise ValueError(f's2d={self.s2d!r}: expected off|out_head|all')
        if self.zero_pad and not self.int8:
            raise ValueError('zero_pad requires int8 (it only affects the '
                             'quantized convs)')
        if self.calibrating and not self.int8:
            raise ValueError('calibrating requires int8')

    def but(self, **updates) -> 'ServingMode':
        return _dc_replace(self, **updates)


DEFAULT = ServingMode()
