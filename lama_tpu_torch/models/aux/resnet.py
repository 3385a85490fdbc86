"""The ADE20k ResNet50-dilated encoder, the backbone of ResNetPL
(counterpart of lama_tpu/models/aux/resnet.py; reference
models/ade20k/resnet.py:95-160 with ResnetDilated's dilation surgery,
base.py:393-446, dilate_scale 8).

Deep stem (3x3 s2 -> 64, 3x3 -> 64, 3x3 -> 128, BN + ReLU each, zero pad 1
and a 3x3 s2 max pool), then bottleneck stages [3, 4, 6, 3]. Dilated:
stages 3 and 4 keep stride 1 with dilation 2 and 4 (their first 3x3 conv
dilation 1 and 2). Keys follow torch's (`conv1`, `bn1`, `layer1.0.conv1`,
`layer1.0.downsample.0`, ...), so an ADE20k `encoder_epoch_20.pth` loads.
Convs run in the encoder's `dtype`; BN computes in float32.
"""
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.conv import Conv2d
from ...ops.norm import BatchNorm2d
from ...ops.precision import check_dtype


class Bottleneck(nn.Module):
    def __init__(self, in_planes, planes, stride=1, dilation=1,
                 has_downsample=False):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            Conv2d(in_planes, planes * 4, 1, stride=stride, bias=False),
            BatchNorm2d(planes * 4)) if has_downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNetDilatedEncoder(nn.Module):
    """resnet50dilated (output stride 8); `dilated=False` gives the plain
    stride-32 resnet50. forward returns the four stage outputs."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), dilated=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv2d(64, 64, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.conv3 = Conv2d(64, 128, 3, padding=1, bias=False)
        self.bn3 = BatchNorm2d(128)
        # (planes, stride, dilation, first block's 3x3 dilation)
        stages = ([(64, 1, 1, 1), (128, 2, 1, 1), (256, 1, 2, 1),
                   (512, 1, 4, 2)] if dilated else
                  [(64, 1, 1, 1), (128, 2, 1, 1), (256, 2, 1, 1),
                   (512, 2, 1, 1)])
        in_planes = 128
        for i, ((planes, stride, dilation, first_d), n) in enumerate(
                zip(stages, layers), start=1):
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(
                    in_planes, planes, stride=stride if j == 0 else 1,
                    dilation=first_d if j == 0 else dilation,
                    has_downsample=j == 0 and (stride != 1
                                               or in_planes != planes * 4)))
                in_planes = planes * 4
            setattr(self, f'layer{i}', nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        h = x.to(self.dtype)
        h = torch.relu(self.bn1(self.conv1(h)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = torch.relu(self.bn3(self.conv3(h)))
        h = F.max_pool2d(F.pad(h, (1, 1, 1, 1)), 3, 2)   # zeros after ReLU
        outs = []
        for i in range(1, 5):
            h = getattr(self, f'layer{i}')(h)
            outs.append(h)
        return outs
