"""The benchmark's plain reference of the I2PNet families, in float32:
the layers, the geometry and the heads they share, written with plain
``torch`` operations only: no kernel, no cache, no batching trick. Each
family is a file of its own, ``families/<family>.py`` (the configuration's
``family``), found by name: ``FIXED`` (the options it writes out, with the
only value each takes), ``forward`` and ``schema``. The free-point I2PNet
(IRMVLab/I2PNet ``src/config_lidarcenter.py``) is ``free``, the
projection-aware I2PNetProj (``src/config_proj_lidarcenter.py``) ``proj``.
None of it imports the program; it works out again everything the program
derives from its inputs (the range image, the FPS picks, the KNN sets, the
window selects).

Weights are a flat dict keyed by the program's state-dict names (a
family's ``schema`` lists them with their shapes), so one dict made by the
benchmark loads into both sides. A ``Run`` carries what a forward needs
besides them: train or eval, the rounding of every matmul's and
convolution's operands and of every layer's result (the identity, or the
fp8 control of ``quant.py``) and the dropout uniforms, drawn by the
caller.
"""

from __future__ import annotations

import importlib
import re
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
INVALID_DIST = 1e10


def family(name: str):
    """The module ``families/<name>.py``."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"reference: family {name!r} is no module name")
    return importlib.import_module(f"{__package__}.families.{name}")


def forward(name: str) -> Callable:
    return family(name).forward


def schema(name: str, mc: dict) -> "OrderedDict[str, tuple]":
    return family(name).schema(mc)


def check_supported(name: str, mc: dict) -> None:
    """Raise unless every option the family fixes has its fixed value."""
    for key, want in family(name).FIXED.items():
        if key in mc and _plain(mc[key]) != want:
            raise ValueError(f"reference: {name} option {key}={mc[key]!r} is not written "
                             f"out (only {want!r})")


def _plain(v):
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


class Run:
    """One forward's settings: ``training`` (batch statistics, dropout),
    ``cast`` applied to both operands and the result of every matmul and
    convolution and to every norm's result (a layer's output is stored in
    the precision it names, as the program stores its bf16 ones), and
    ``dropout``, the uniforms (B, 1, hidden) of the heads' dropout in the
    order the heads run (l4, then l3)."""

    def __init__(self, params: Dict[str, torch.Tensor], training: bool = False,
                 cast: Optional[Callable] = None, dropout: Optional[List[torch.Tensor]] = None,
                 dropout_rate: float = 0.5, stats: Optional[dict] = None):
        self.p = params
        self.training = training
        self.cast = cast or (lambda x: x)
        self.dropout = list(dropout or [])
        self.dropout_rate = dropout_rate
        # with a dict, every BatchNorm's batch statistics are stored under its name
        self.stats = stats


# --- layers ------------------------------------------------------------------

def dense(r: Run, name: str, x):
    w, b = r.p[f"{name}.weight"], r.p[f"{name}.bias"]
    return r.cast(torch.matmul(r.cast(x), r.cast(w).t()) + b)


def batch_norm(r: Run, name: str, x):
    """BatchNorm over the last axis: batch statistics in training (the
    variance as E[x^2] - E[x]^2, clipped at 0), running ones at eval."""
    if r.training:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        if r.stats is not None:
            r.stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = r.p[f"{name}.running_mean"], r.p[f"{name}.running_var"]
    return r.cast((x - mean) * (torch.rsqrt(var + BN_EPS) * r.p[f"{name}.weight"])
                  + r.p[f"{name}.bias"])


def batch_stats_norm(r: Run, name: str, x):
    """Normalisation by the current batch's statistics (two-pass variance),
    in training and at eval alike."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    var = torch.square(x - mean).mean(dims)
    return r.cast((x - mean) * torch.rsqrt(var + BN_EPS) * r.p[f"{name}.weight"]
                  + r.p[f"{name}.bias"])


def leaky(x):
    return F.leaky_relu(x, 0.1)


def pointwise(r: Run, name: str, x, norm: Optional[str] = "bn", act: Optional[str] = "leaky"):
    x = dense(r, f"{name}.Dense_0", x)
    if norm == "bn":
        x = batch_norm(r, f"{name}.BatchNorm_0", x)
    elif norm == "stats":
        x = batch_stats_norm(r, f"{name}.BatchStatsNorm_0", x)
    if act == "leaky":
        x = leaky(x)
    elif act == "relu":
        x = torch.relu(x)
    return x


def mlp(r: Run, name: str, x, depth: int, norm: str = "bn", act: str = "leaky"):
    for i in range(depth):
        x = pointwise(r, f"{name}.PointwiseConv_{i}", x, norm, act)
    return x


def softmax(x, dim: int):
    return torch.softmax(x, dim=dim)


def rgb_encoder(r: Run, stages, rgb):
    """rgb (B, H, W, 3) -> the last stage's map (B, h, w, C): per block a
    3x3 convolution, BatchNorm, LeakyReLU(0.1) and a 3x3 max-pool (pad 1)
    at the block's stride."""
    x = rgb.permute(0, 3, 1, 2)
    for i, (_, channels, strides) in enumerate(stages):
        for j, s in enumerate(strides):
            name = f"rgb_encoder.RGBEncoderStage_{i}"
            w, b = r.p[f"{name}.Conv_{j}.weight"], r.p[f"{name}.Conv_{j}.bias"]
            y = r.cast(F.conv2d(r.cast(x), r.cast(w), padding=1) + b[:, None, None])
            y = batch_norm(r, f"{name}.BatchNorm_{j}", y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = F.max_pool2d(leaky(y), 3, s, 1)
    return x.permute(0, 2, 3, 1)


# --- geometry ----------------------------------------------------------------

def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def qinv(q):
    conj = torch.cat([q[..., :1], -q[..., 1:]], dim=-1)
    return conj / (torch.sum(q * q, dim=-1, keepdim=True) + 1e-10)


def qrotate(q, v):
    vq = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return qmul(qmul(q, vq), qinv(q))[..., 1:4]


def warp_points(xyz, q, t):
    """R(q) x + t on (B, N, 3), q (B, 4) as (w, x, y, z)."""
    return qrotate(q[:, None, :], xyz) + t[:, None, :]


def compose_pose(q_outer, t_outer, q_inner, t_inner):
    q = qmul(q_outer, q_inner)
    t = qrotate(q_outer[:, None, :], t_inner[:, None, :])[:, 0, :] + t_outer
    return q, t


def safe_norm(x, dim=-1, keepdim=False):
    sumsq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    positive = sumsq > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, sumsq, torch.ones_like(sumsq))),
                       0.0)


def index_points(points, idx):
    B = points.shape[0]
    rows = torch.arange(B, device=points.device).view((B,) + (1,) * (idx.dim() - 1))
    return points[rows, idx]


def square_distance(src, dst):
    """|s|^2 + |d|^2 - 2 s.d, the cross term a float32 batched matmul."""
    cross = torch.bmm(src, dst.transpose(1, 2))
    return (torch.sum(src * src, -1)[:, :, None] + torch.sum(dst * dst, -1)[:, None, :]
            - 2.0 * cross)


def knn(k: int, xyz, query):
    """The k nearest points of xyz to each query, nearest first, equal
    distances lowest index first (a stable sort)."""
    return torch.sort(square_distance(query, xyz), dim=-1, stable=True).indices[..., :k]


def fps(xyz, npoint: int):
    """Farthest point sampling from index 0; the distance's terms are
    separate operations and argmax takes the first maximum."""
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    dist = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=xyz.device)
    far = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    out = torch.empty(B, npoint, dtype=torch.int64, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]
        dx, dy, dz = x - c[:, 0:1], y - c[:, 1:2], z - c[:, 2:3]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        far = torch.argmax(dist, dim=-1)
    return out


def mean_std_normalize(x, eps: float = 1e-12):
    mean = x.mean(-1, keepdim=True)
    var = torch.sum((x - mean) ** 2, -1, keepdim=True) / max(x.shape[-1] - 1, 1)
    return (x - mean) / torch.clamp(torch.sqrt(var), min=eps)


def inverse_intrinsic_grid(intrinsic, h3: int, w3: int, H: int, W: int):
    """K scaled to the (h3, w3) feature grid, inverted, applied to every
    pixel (u = column, v = row, 1): (B, h3*w3, 3)."""
    B = intrinsic.shape[0]
    k = intrinsic.clone()
    k[:, 0, 0] *= w3 / W
    k[:, 0, 2] *= w3 / W
    k[:, 1, 1] *= h3 / H
    k[:, 1, 2] *= h3 / H
    ii, jj = torch.meshgrid(torch.arange(h3, dtype=torch.float32, device=k.device),
                            torch.arange(w3, dtype=torch.float32, device=k.device), indexing="ij")
    grid = torch.stack([jj, ii, torch.ones_like(jj)], -1).reshape(1, h3 * w3, 3).expand(B, -1, 3)
    return torch.einsum("bij,bnj->bni", torch.linalg.inv(k), grid)


# --- the heads -----------------------------------------------------------------

def pose_head(r: Run, name: str, prediction, mask):
    """Softmax over the points of the mask weighs the prediction; hidden
    Dense, dropout in training, the q and t Dense heads; q normalised."""
    pooled = torch.sum(prediction * softmax(mask, 1), dim=1, keepdim=True)
    hidden = dense(r, f"{name}.hidden_layer", pooled)
    if r.training and r.dropout_rate > 0:
        u = r.dropout.pop(0)
        hidden = torch.where(u < 1.0 - r.dropout_rate, hidden / (1.0 - r.dropout_rate),
                             torch.zeros_like(hidden))
    q = dense(r, f"{name}.quat_head", hidden)[:, 0]
    t = dense(r, f"{name}.trans_head", hidden)[:, 0]
    q = q / (torch.sqrt(torch.sum(q * q, -1, keepdim=True) + 1e-10) + 1e-10)
    return q, t


def flow_predictor(r: Run, name: str, parts, depth: int, norm: str):
    return mlp(r, f"{name}.mlp_conv", torch.cat(parts, -1), depth, norm)



# --- the weights' names and shapes ---------------------------------------------

class Schema:
    """A family's weights in the order the benchmark draws them: name ->
    (shape, kind), kind one of weight (a Dense or convolution matrix), bias,
    scale, shift, running_mean, running_var, sq, sx. Starts with sq, sx and
    the RGB encoder; ``norm`` is the class name of the family's pointwise
    norms (BatchNorm keeps running statistics, BatchStatsNorm none)."""

    def __init__(self, mc: dict, norm: str):
        self.mc, self.norm = mc, norm
        self.out: "OrderedDict[str, tuple]" = OrderedDict()
        self.out["sq"] = ((1,), "sq")
        self.out["sx"] = ((1,), "sx")
        for i, (cin, chans, _) in enumerate(mc["rgb_encoder_channels"]):
            for j, c in enumerate(chans):
                name = f"rgb_encoder.RGBEncoderStage_{i}"
                self.out[f"{name}.Conv_{j}.weight"] = ((c, cin, 3, 3), "weight")
                self.out[f"{name}.Conv_{j}.bias"] = ((c,), "bias")
                self.bn(f"{name}.BatchNorm_{j}", c)
                cin = c
        mlps, cvm = mc["lidar_encoder_mlps"], mc["cost_volume_mlps"]
        self.C3, self.D, self.L4 = mlps[2][-1], cvm[0][-1], mlps[4][-1]

    def lin(self, name, fin, fout):
        self.out[f"{name}.weight"] = ((fout, fin), "weight")
        self.out[f"{name}.bias"] = ((fout,), "bias")

    def bn(self, name, f, running=True):
        self.out[f"{name}.weight"] = ((f,), "scale")
        self.out[f"{name}.bias"] = ((f,), "shift")
        if running:
            self.out[f"{name}.running_mean"] = ((f,), "running_mean")
            self.out[f"{name}.running_var"] = ((f,), "running_var")

    def pw(self, name, fin, fout):
        self.lin(f"{name}.Dense_0", fin, fout)
        self.bn(f"{name}.{self.norm}_0", fout, self.norm == "BatchNorm")
        return fout

    def stack(self, name, fin, widths):
        for i, f in enumerate(widths):
            fin = self.pw(f"{name}.PointwiseConv_{i}", fin, f)
        return fin

    def cost(self, name, bval):
        cvm, C3, D = self.mc["cost_volume_mlps"], self.C3, self.D
        self.stack(f"{name}.mlp1_convs", 6 + C3 + (C3 if bval else 0), cvm[0])
        self.pw(f"{name}.pi_encoding", 6, D)
        self.stack(f"{name}.mlp2_convs", 2 * D, cvm[1])
        self.pw(f"{name}.pc_encoding", 10, D)
        self.stack(f"{name}.mlp2_convs_2", 2 * D + C3, cvm[1])

    def head(self, name, width):
        hidden = self.mc["head_hidden_dim"]
        self.lin(f"{name}.hidden_layer", width, hidden)
        self.lin(f"{name}.quat_head", hidden, 4)
        self.lin(f"{name}.trans_head", hidden, 3)

    def upconv(self, name, i, feat2):
        upm = self.mc["setupconv_mlps"]
        w = self.stack(f"{name}.mlp_conv", feat2 + 3, upm[i][0])
        self.stack(f"{name}.mlp2_conv", w + self.C3, upm[i][1])
        return upm[i][1][-1]

    def refined_head(self):
        """The last two flow predictors and the l3 head."""
        fpm, upm = self.mc["flow_predictor_mlps"], self.mc["setupconv_mlps"]
        self.stack("flow_predictor0_predict.mlp_conv", self.C3 + self.D + upm[1][1][-1], fpm[1])
        self.stack("flow_predictor0_w.mlp_conv", self.C3 + fpm[1][-1] + upm[0][1][-1], fpm[2])
        self.head("l3_head", fpm[1][-1])
        return self.out
