"""ResNet image encoder (port of ``i2pnet_tpu/nn/resnet.py``): the
reference's optional alternative to the RGB encoder, unused by the shipped
models. NHWC in, the (C3, C4, C5) pyramid at stride 8/16/32 out.

Submodules carry the flax scopes' names (``stem_conv``, ``stem_bn``,
``stage{si}_block{bi}`` with ``Conv_0``, ``BatchNorm_0``, ``Conv_1``,
``BatchNorm_1``, ``downsample_conv``, ``downsample_bn``), so
``convert.load_flax_variables`` carries JAX's weights as they are. The
convolutions run in ``dtype`` when given (their result in it, as flax's
``Conv``); every BatchNorm is f32 (flax's statistics and momentum,
``nn/layers.py`` ``BatchNorm``). Tensors stay NHWC; a convolution sees them
as a channels-last NCHW view.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from i2pnet_tpu_torch.nn.layers import BatchNorm

STEM_WIDTH = 64


def _conv(x: torch.Tensor, conv: nn.Conv2d, stride: int, padding: int,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Conv`` without bias on NHWC x: operands in ``dtype`` (or
    their promoted type), the result in it."""
    dt = dtype or torch.promote_types(x.dtype, conv.weight.dtype)
    y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


class BasicBlock(nn.Module):
    """conv3x3 -> BN -> ReLU -> conv3x3 -> BN, + the residual, -> ReLU.

    flax builds the 1x1 ``downsample`` pair when the residual's shape
    differs from the block's output; here it is built for ``in_channels !=
    features or strides != 1``, the same answer on any map larger than one
    pixel. Where a stride-2 block with equal widths meets a one-pixel map,
    flax builds none, and ``load_flax_variables`` raises on the missing
    leaves."""

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.strides, self.dtype = strides, dtype
        self.Conv_0 = nn.Conv2d(in_channels, features, 3, bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, bias=False)
        self.BatchNorm_1 = BatchNorm(features)
        downsample = in_channels != features or strides != 1
        self.downsample_conv = nn.Conv2d(in_channels, features, 1, bias=False) if downsample \
            else None
        self.downsample_bn = BatchNorm(features) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(_conv(x, self.Conv_0, self.strides, 1, self.dtype)))
        y = self.BatchNorm_1(_conv(y, self.Conv_1, 1, 1, self.dtype))
        residual = x
        if self.downsample_conv is not None:
            # a 1x1 convolution at stride s reads every s-th pixel: slice, then
            # stride 1 (PyTorch's CPU backward of a strided 1x1 convolution
            # on a channels-last view crashes)
            s = self.strides
            residual = self.downsample_bn(_conv(x[:, ::s, ::s], self.downsample_conv, 1, 0,
                                                self.dtype))
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    """ResNet-{18, 34}-style pyramid encoder (ResNet-34 by default).

    A 7x7 stride-2 stem (64 channels, no bias), BN, ReLU and a 3x3 stride-2
    max-pool padded with -inf, then ``stage_sizes[si]`` BasicBlocks of
    ``widths[si]`` channels a stage, each stage after the first opening at
    stride 2. Returns the last three stages' outputs (C3, C4, C5), NHWC f32."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512), dtype: Optional[torch.dtype] = None,
                 in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = nn.Conv2d(in_channels, STEM_WIDTH, 7, bias=False)
        self.stem_bn = BatchNorm(STEM_WIDTH)
        cin = STEM_WIDTH
        self.stages = []
        for si, (blocks, width) in enumerate(zip(stage_sizes, widths)):
            stage = []
            for bi in range(blocks):
                block = BasicBlock(cin, width, 2 if (si > 0 and bi == 0) else 1, dtype)
                self.add_module(f"stage{si}_block{bi}", block)
                stage.append(block)
                cin = width
            self.stages.append(stage)

    def forward(self, x: torch.Tensor):
        """x (B, H, W, C) -> (C3, C4, C5), each (B, h, w, width) f32."""
        x = F.relu(self.stem_bn(_conv(x, self.stem_conv, 2, 3, self.dtype)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
        outs = []
        for stage in self.stages:
            for block in stage:
                x = block(x)
            outs.append(x)
        return outs[1], outs[2], outs[3]
