"""Prediction heads (port of ``i2pnet_tpu/nn/heads.py``): FlowPredictor,
PoseHead (with its projection-mask input, the sigmoid variant, the
``mlp1``/``mlp2`` re-weighting and its correlations and position
embedding), ProjectMask and ``delay_weight``."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from i2pnet_tpu_torch.nn.layers import Dense, PointwiseConv, PointwiseMLP, cat, softmax

HEAD_CORR_FUNCS = ("concat", "diff", "normalized_diff")


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


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / (std + 1e-10) over channels, std with ddof=1 (jnp.std)."""
    m = torch.mean(x, dim=-1, keepdim=True)
    s = torch.sqrt(torch.sum((x - m) ** 2, dim=-1, keepdim=True) / (x.shape[-1] - 1))
    return (x - m) / (s + 1e-10)


class PoseHead(nn.Module):
    """Softmax pooling of the prediction under the mask -> hidden Dense ->
    dropout -> (q, t) Dense heads; q L2-normalised. ``split_dp`` gives the
    q and t heads a dropout each (``dp2q``/``dp2t``) in place of the shared
    ``dp1``. ``in_channels`` is the prediction's width.

    A projection mask (B, N, 2) keeps the points whose argmax is 1 (taken
    without gradient) and fills the others' mask with -1e10; with
    ``sigmoid`` the prediction is multiplied by the mask (B, N, 1) instead,
    which then must be given. Non-empty ``mlp1`` re-weights the points a
    second time: the pooled prediction is correlated with every point
    (``corr_func``: ``concat``, ``diff`` or ``normalized_diff``), optionally
    joined by a position embedding of [xyz, xyz - mean] (``pos_embed``,
    ``pos_encoder``), passed through ``mlps`` (and ``mlp2s`` on [that,
    mask, feature]), and a softmax over the points pools the prediction.
    ``mask_channels`` and ``feature_channels`` are the mask's and the
    feature's widths (``mlp2s`` reads them)."""

    def __init__(self, in_channels: int, hidden: int, q_dim: int = 4, t_dim: int = 3,
                 mlp1: Sequence[int] = (), mlp2: Sequence[int] = (), sigmoid: bool = False,
                 maxhead: bool = False, dropout_rate: float = 0.5, split_dp: bool = False,
                 corr_func: str = "concat", pos_embed: bool = False, mask_channels: int = 0,
                 feature_channels: int = 0):
        super().__init__()
        self.sigmoid, self.maxhead = sigmoid, maxhead
        self.dropout_rate, self.split_dp = dropout_rate, split_dp
        self.corr_func, self.pos_embed = corr_func, pos_embed
        self.mlps = self.mlp2s = self.pos_encoder = None
        if mlp1:
            if corr_func not in HEAD_CORR_FUNCS:
                raise ValueError(f"PoseHead corr_func={corr_func!r}: expected one of "
                                 f"{HEAD_CORR_FUNCS}")
            width = 2 * in_channels if corr_func == "concat" else in_channels
            if pos_embed:
                self.pos_encoder = PointwiseConv(6, in_channels, use_bn=True)
                width += in_channels
            self.mlps = PointwiseMLP(width, mlp1)
            if mlp2:
                mask_width = 1 if maxhead else mask_channels
                self.mlp2s = PointwiseMLP(mlp1[-1] + mask_width + feature_channels, mlp2)
        self.hidden_layer = Dense(in_channels, hidden)
        self.quat_head = Dense(hidden, q_dim)
        self.trans_head = Dense(hidden, t_dim)

    def forward(self, prediction, mask, xyz=None, feature=None, projection_mask=None,
                generator: Optional[torch.Generator] = None):
        """prediction (B,N,C), mask (B,N,C or 1), xyz (B,N,3) and feature
        (B,N,F) for the ``mlp1`` branch, projection_mask (B,N,2), or (B,N,1)
        with ``sigmoid`` -> (q (B,4), t (B,3), mask_p); ``generator`` feeds
        the dropout in training."""
        if self.sigmoid:
            if projection_mask is None:
                raise TypeError("a sigmoid PoseHead multiplies the prediction by the projection "
                                "mask, and none was given")
            prediction = prediction * projection_mask
        elif projection_mask is not None:
            pm = torch.argmax(projection_mask.detach(), dim=-1)[..., None].to(mask.dtype)
            mask = mask * pm + -1e10 * (1.0 - pm)
        if self.maxhead:
            mask = torch.amax(mask, dim=-1, keepdim=True)
        mask_p = softmax(mask, dim=1)
        global_prediction = torch.sum(prediction * mask_p, dim=1, keepdim=True)

        if self.mlps is not None:
            if self.corr_func == "concat":
                g = cat([prediction, global_prediction.expand_as(prediction)], -1)
            elif self.corr_func == "diff":
                g = prediction - global_prediction
            else:
                g = _normalize(prediction) * _normalize(global_prediction)
            if self.pos_embed:
                center = xyz - torch.mean(xyz, dim=1, keepdim=True)
                g = cat([g, self.pos_encoder(torch.cat([xyz, center], dim=-1))], -1)
            g = self.mlps(g)
            if self.mlp2s is not None:
                g = self.mlp2s(cat([g, mask, feature], -1))
            result = torch.sum(softmax(g, dim=1) * prediction, dim=1, keepdim=True)
        else:
            result = global_prediction
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


class ProjectMask(nn.Module):
    """The projection-mask classifier: [feature, prediction] -> pointwise
    convs (``mlp_i``) -> Dense (``out``) to 2 logits, or to 1 probability
    with ``sigmoid``. ``in_channels`` is the input's width (feature's and
    prediction's). The JAX module's dropout between the convs is left out:
    no model sets its rate, which is 0."""

    def __init__(self, in_channels: int, mlp: Sequence[int], sigmoid: bool = False):
        super().__init__()
        self.sigmoid = sigmoid
        self.layers = []
        for i, f in enumerate(mlp):
            layer = PointwiseConv(in_channels, f, use_bn=True)
            self.add_module(f"mlp_{i}", layer)
            self.layers.append(layer)
            in_channels = f
        self.out = Dense(in_channels, 1 if sigmoid else 2)

    def forward(self, feature, prediction):
        x = cat([feature, prediction], -1) if feature is not None else prediction
        for layer in self.layers:
            x = layer(x)
        out = self.out(x)
        return torch.sigmoid(out) if self.sigmoid else out


def delay_weight(gt: Optional[torch.Tensor], pred: Optional[torch.Tensor],
                 now_step: torch.Tensor, delay_step: int, ab_delay: bool = False):
    """The gt -> prediction annealing of the projection masks: with both
    given, ``gt * w + softmax(pred) * (1 - w)`` for ``w = now_step /
    delay_step`` (``now_step`` counts down from ``delay_step`` to 0, a
    tensor); with ``ab_delay`` gt while ``now_step > 0``, then pred."""
    if gt is None:
        return pred
    if pred is None:
        return gt
    if ab_delay:
        return torch.where(now_step > 0, gt, pred)
    pred = softmax(pred, dim=-1)
    w = now_step.to(pred.dtype) / (delay_step + 1e-10)
    return gt * w + pred * (1.0 - w)
