"""The ADE20k MobileNetV2-dilated encoder (counterpart of
lama_tpu/models/aux/mobilenet.py; reference models/ade20k/mobilenet.py and
base.py:459-511, MobileNetV2Dilated with dilate_scale 8), the light
alternative to resnet50dilated in the segmentation module, paired with the
C1-DeepSup decoder.

ReLU6 activations; the trunk without the classifier and without the final
1x1 conv (the reference's features[:-1]). The dilate surgery: features[7:14]
take dilation 2 and features[14:] dilation 4; a depthwise 3x3 conv whose
stride was 2 runs at stride 1 with dilation (and padding) half that, the
others with the full dilation; the residual is decided by the stride before
the surgery. Keys follow the reference's (`features.0.0` and `features.0.1`
for the first conv and BN, `features.{i}.conv.{j}` inside the inverted
residuals), so an ADE20k `encoder_epoch_20.pth` loads.
"""
from typing import List

import torch
import torch.nn as nn

from ...ops.conv import Conv2d
from ...ops.norm import BatchNorm2d

# t (expansion), c (channels), n (blocks), s (first block's stride)
SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
DOWN_IDX = (2, 4, 7, 14)


def surgery_dilation(idx: int) -> int:
    return 4 if idx >= DOWN_IDX[-1] else 2 if idx >= DOWN_IDX[-2] else 1


class InvertedResidual(nn.Module):
    """reference mobilenet.py:38-76 with the dilate surgery applied to its
    depthwise conv."""

    def __init__(self, in_ch, out_ch, stride, expand_ratio, dilation=1):
        super().__init__()
        hidden = round(in_ch * expand_ratio)
        dw_stride = 1 if dilation > 1 else stride
        d = max(dilation // 2, 1) if stride == 2 else dilation
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if expand_ratio != 1:
            layers += [Conv2d(in_ch, hidden, 1, bias=False),
                       BatchNorm2d(hidden), nn.ReLU6()]
        layers += [Conv2d(hidden, hidden, 3, stride=dw_stride, padding=d,
                          dilation=d, groups=hidden, bias=False),
                   BatchNorm2d(hidden), nn.ReLU6(),
                   Conv2d(hidden, out_ch, 1, bias=False), BatchNorm2d(out_ch)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2DilatedEncoder(nn.Module):
    """forward returns the maps after features 2, 4, 7 and 14 and the last
    one (320 channels at 1/8 of the input)."""

    def __init__(self):
        super().__init__()
        features = [nn.Sequential(Conv2d(3, 32, 3, stride=2, padding=1,
                                         bias=False),
                                  BatchNorm2d(32), nn.ReLU6())]
        in_ch = 32
        for t, c, n, s in SETTINGS:
            for i in range(n):
                features.append(InvertedResidual(
                    in_ch, c, s if i == 0 else 1, t,
                    dilation=surgery_dilation(len(features))))
                in_ch = c
        self.features = nn.Sequential(*features)

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in DOWN_IDX:
                outs.append(x)
        outs.append(x)
        return outs
