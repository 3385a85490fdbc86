"""The FID InceptionV3 of pytorch-fid, NCHW (counterpart of
lama_tpu/models/aux/inception.py; reference saicinpainting/evaluation/
losses/fid/inception.py:21-323).

The FID variant differs from torchvision's InceptionV3: the pool branches
of InceptionA, InceptionC and the first InceptionE average with
count_include_pad=False, and the last InceptionE (Mixed_7c) takes a max
pool branch. BatchNorm eps is 1e-3. The input is [0, 1] RGB, resized to
299^2 (bilinear, align_corners=False, no anti-aliasing) and mapped to
[-1, 1]. Output blocks follow pytorch-fid's numbering: 0 the first max
pool (64 channels), 1 the second (192), 2 Mixed_6e (768), 3 the global
average pool (2048, the FID feature).

Module names follow pytorch-fid's `pt_inception-2015-12-05` state_dict
(`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch3x3dbl_1.bn.running_mean`,
...), so that file loads into this module once its classifier entries
(`fc.*`, `AuxLogits.*`, which FID does not use) are dropped
(`fid_state_dict`).
"""
from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from ...ops.conv import Conv2d
from ...ops.norm import BatchNorm2d
from ...ops.pool import (adaptive_avg_pool2d, avg_pool_3x3_same_exclude_pad,
                         max_pool2d, max_pool_3x3_same)
from ...ops.resize import interpolate


class BasicConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                           padding=padding, bias=False)
        self.bn = BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, in_ch, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3_same_exclude_pad(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch, channels_7x7):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f'branch7x7dbl_{i}')(bd)
        bp = self.branch_pool(avg_pool_3x3_same_exclude_pad(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f'branch7x7x3_{i}')(b7)
        return torch.cat([b3, b7, max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch, pool_kind='avg'):
        super().__init__()
        self.pool_kind = pool_kind   # 'avg' (Mixed_7b), 'max' (Mixed_7c)
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = (avg_pool_3x3_same_exclude_pad(x) if self.pool_kind == 'avg'
              else max_pool_3x3_same(x))
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


class FIDInceptionV3(nn.Module):
    """Returns the requested output blocks (NCHW); block 3, (B, 2048, 1, 1),
    is the FID feature."""

    def __init__(self, output_blocks: Sequence[int] = (3,)):
        super().__init__()
        self.output_blocks = tuple(output_blocks)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, 'avg')
        self.Mixed_7c = InceptionE(2048, 'max')

    def forward(self, x) -> List[torch.Tensor]:
        x = interpolate(x.float(), size=(299, 299), mode='bilinear',
                        align_corners=False)
        x = 2 * x - 1
        last = max(self.output_blocks)
        outs = []
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        h = max_pool2d(h, 3, 2)
        if 0 in self.output_blocks:
            outs.append(h)
        if last == 0:
            return outs
        h = max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h)), 3, 2)
        if 1 in self.output_blocks:
            outs.append(h)
        if last == 1:
            return outs
        for name in ('Mixed_5b', 'Mixed_5c', 'Mixed_5d', 'Mixed_6a',
                     'Mixed_6b', 'Mixed_6c', 'Mixed_6d', 'Mixed_6e'):
            h = getattr(self, name)(h)
        if 2 in self.output_blocks:
            outs.append(h)
        if last == 2:
            return outs
        h = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(h)))
        outs.append(adaptive_avg_pool2d(h, 1))
        return outs


def fid_state_dict(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """pytorch-fid's InceptionV3 state_dict without the classifier entries
    FID does not use (`fc.*`, `AuxLogits.*`), for a strict load."""
    return {k: v for k, v in state.items()
            if not k.startswith(('fc.', 'AuxLogits.'))}
