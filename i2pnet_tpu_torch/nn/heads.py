"""Prediction heads (port of ``i2pnet_tpu/nn/heads.py``): FlowPredictor
and PoseHead, with PoseHead's dropout in training. ``ProjectMask``/
``delay_weight`` and PoseHead's mask, ``mlp1``/``mlp2`` and sigmoid
branches are not ported yet."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from i2pnet_tpu_torch.nn.layers import Dense, PointwiseMLP, cat, softmax


class FlowPredictor(nn.Module):
    """Concat [points_f1, cost_volume(, upsampled)] -> pointwise MLP."""

    def __init__(self, in_channels: int, mlp: Sequence[int], dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp_conv = PointwiseMLP(in_channels, mlp, dtype=dtype)

    def forward(self, points_f1, upsampled_feat, cost_volume):
        parts = [points_f1, cost_volume]
        if upsampled_feat is not None:
            parts.append(upsampled_feat)
        return self.mlp_conv(cat(parts, -1))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: in training keep each element with probability
    1 - rate and scale it by 1 / (1 - rate), drawing from ``generator`` (on
    x's device; None takes the default generator); the identity at eval or
    when the rate is 0. The bits are not JAX's: only the statistics match."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class PoseHead(nn.Module):
    """Softmax pooling of the prediction under the mask -> hidden Dense ->
    dropout -> (q, t) Dense heads; q L2-normalised. ``split_dp`` gives the
    q and t heads a dropout each (``dp2q``/``dp2t``) in place of the shared
    ``dp1``. ``in_channels`` is the prediction's width."""

    def __init__(self, in_channels: int, hidden: int, q_dim: int = 4, t_dim: int = 3,
                 mlp1: Sequence[int] = (), mlp2: Sequence[int] = (), sigmoid: bool = False,
                 maxhead: bool = False, dropout_rate: float = 0.5, split_dp: bool = False):
        super().__init__()
        if mlp1 or mlp2 or sigmoid:
            raise NotImplementedError("PoseHead mlp1/mlp2/sigmoid is not ported yet")
        self.maxhead = maxhead
        self.dropout_rate, self.split_dp = dropout_rate, split_dp
        self.hidden_layer = Dense(in_channels, hidden)
        self.quat_head = Dense(hidden, q_dim)
        self.trans_head = Dense(hidden, t_dim)

    def forward(self, prediction, mask, xyz=None, feature=None, projection_mask=None,
                generator: Optional[torch.Generator] = None):
        """prediction (B,N,C), mask (B,N,C or 1) -> (q (B,4), t (B,3), mask_p);
        ``generator`` feeds the dropout in training."""
        if projection_mask is not None:
            raise NotImplementedError("PoseHead projection masks are not ported yet")
        if self.maxhead:
            mask = torch.amax(mask, dim=-1, keepdim=True)
        mask_p = softmax(mask, dim=1)
        result = torch.sum(prediction * mask_p, dim=1, keepdim=True)
        hidden = self.hidden_layer(result)

        def dp(h):
            return dropout(h, self.dropout_rate, self.training, generator)

        if self.split_dp:
            h2q, h2t = dp(hidden), dp(hidden)
        else:
            h2q = h2t = dp(hidden)
        q = self.quat_head(h2q)[:, 0, :]
        t = self.trans_head(h2t)[:, 0, :]
        q = q / (torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-10) + 1e-10)
        return q, t, mask_p
