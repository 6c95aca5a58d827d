"""Model configurations of the port: its own copies of the free-point
``I2PNetConfig`` and the projection-family ``I2PNetProjConfig`` of
``i2pnet_tpu/config.py``, field for field and default for default
(``tests/test_torch_config.py`` holds each pair together), so the port
imports nothing of the JAX package.

Frozen, hashable dataclasses; ``tiny()`` is each family's small test
config, ``lidar_layer_points`` the point count of each free-point
set-abstraction level, ``lidar_Hs``/``lidar_Ws`` the range-grid size of
each projection level.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class I2PNetConfig:
    """Free-point I2PNet (ref src/config_lidarcenter.py:4-105).

    Defaults reproduce the shipped small-range / online-calibration model.
    """

    # --- RGB encoder: (in_channels, conv channels, maxpool strides) per stage
    # (ref config_lidarcenter.py:6-11)
    rgb_encoder_channels: Tuple[Tuple[int, Tuple[int, ...], Tuple[int, ...]], ...] = (
        (3, (16, 16, 16, 16, 32), (2, 1, 1, 1, 2)),
        (32, (32, 32, 32, 32, 64), (2, 1, 1, 1, 2)),
        (64, (64, 64, 64, 64, 128), (1, 1, 1, 1, 2)),
    )

    # --- LiDAR encoder (ref :13-39)
    lidar_downsample_rate: Tuple[int, ...] = (4, 2, 4, 4)
    lidar_in_points: int = 8192
    lidar_feature_size: int = 7
    featmode: Optional[str] = "dim10feat"
    raw_feat_point: bool = True
    lidar_group_samples: Tuple[int, ...] = (32, 16, 16, 16, 16)
    lidar_encoder_mlps: Tuple[Tuple[int, ...], ...] = (
        (16, 16, 32),
        (32, 32, 64),
        (64, 64, 128),
        (128, 128, 256),
        (128, 64, 64),  # set conv for cost volume resampling
    )

    # --- cost volume (ref :41-52)
    backward_fc: bool = False
    cost_volume_mlps: Tuple[Tuple[int, ...], ...] = ((128, 64, 64), (128, 64))
    cost_volume_nsample: int = 4  # 3D neighborhood size
    cost_volume_nsamples_q: Tuple[int, int] = (-1, 32)  # image pixels per point
    cost_volume_corr_func: str = "elementwise_product"  # | concat | cosine
    backward_validation: Tuple[bool, bool] = (True, False)
    max_cost: bool = False

    # --- upconv (ref :54-58)
    setupconv_mlps: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...] = (
        ((128, 64), (64,)),
        ((128, 64), (64,)),
    )
    setupconv_nsamples: Tuple[int, int] = (8, 8)

    # --- flow predictors (ref :60-62)
    flow_predictor_mlps: Tuple[Tuple[int, ...], ...] = ((128, 64), (128, 64), (128, 64))

    # --- pose head (ref :64-75)
    pose_head_mlps: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...] = (
        ((), ()),
        ((), ()),
    )
    head_hidden_dim: int = 256
    rotation_quat_head_dim: int = 4
    transition_vec_head_dim: int = 3
    head_dropout_rate: float = 0.5
    head_corr_func: str = "concat"  # | diff | normalized_diff
    head_pos_embedding: bool = False
    split_dp: bool = False
    max_head: bool = False

    # --- projection mask (ref :77-94)
    use_projection_mask: bool = False
    layer_mask: Tuple[bool, bool] = (False, True)
    projection_mask_mlps: Tuple[Tuple[int, ...], ...] = ((128, 64), (128, 64))
    mask_sigmoid: bool = False
    one_head_mask: bool = False
    ground_truth_projection_mask: bool = False
    ground_truth_projection_mask_eval: bool = False
    ground_truth_mask_layer: Tuple[bool, bool] = (False, True)
    ab_delay: bool = False
    mask_delay: bool = False
    mask_delay_step: int = 1904 * 8 * 30

    # --- online-calibration EFGH variant: project lidar through a full
    # per-sample calib matrix (P_2 @ Tr) instead of assuming camera-frame
    # points + intrinsics (not ported yet: the model raises on it)
    efgh: bool = False

    # --- compute dtype for conv/dense stacks ('float32'|'bfloat16');
    # params and normalization statistics stay f32 (mixed precision)
    compute_dtype: str = "float32"
    # remat the RGB encoder stages in the JAX package; no effect on the
    # port's numerics
    encoder_remat: bool = False
    # apply BN normalization in compute_dtype (stats stay f32); no effect at
    # compute_dtype=float32
    encoder_bn_compute_dtype: bool = True
    # the JAX package's GSPMD stride-1 pool reroute for spatial sharding;
    # the port has no such partitioner and ignores it
    spatial_parallel: bool = False

    # --- loss (ref :96-103)
    sq_init: float = -2.5
    sx_init: float = 0.0
    l1_trans_loss: bool = True
    pointwise_reproject_loss: bool = False
    focal_mask_loss: bool = True
    focal_gamma: float = 2.0

    @property
    def lidar_layer_points(self) -> Tuple[int, ...]:
        pts, n = [], self.lidar_in_points
        for s in self.lidar_downsample_rate:
            n //= s
            pts.append(n)
        return tuple(pts)

    @classmethod
    def tiny(cls) -> "I2PNetConfig":
        """Small config for tests / multi-chip dry runs (fast compile)."""
        return cls(
            # NOTE: last RGB channel must equal lidar mlps[2][-1] for the
            # elementwise-product correlation (as in the shipped 128/128).
            rgb_encoder_channels=(
                (3, (8, 8), (2, 2)),
                (8, (8, 16), (2, 2)),
                (16, (16, 32), (1, 2)),
            ),
            lidar_downsample_rate=(2, 2, 2, 2),
            lidar_in_points=512,
            lidar_group_samples=(8, 8, 8, 8, 8),
            lidar_encoder_mlps=(
                (8, 16),
                (16, 16),
                (16, 32),
                (32, 32),
                (16, 16),
            ),
            cost_volume_mlps=((16, 16), (16, 16)),
            cost_volume_nsamples_q=(-1, 8),
            setupconv_mlps=(((16,), (16,)), ((16,), (16,))),
            setupconv_nsamples=(4, 4),
            flow_predictor_mlps=((16, 16), (16, 16), (16, 16)),
            head_hidden_dim=32,
        )


@dataclasses.dataclass(frozen=True)
class I2PNetProjConfig:
    """Projection-aware I2PNet (ref src/config_proj_lidarcenter.py:6-147).

    Defaults reproduce the shipped KITTI large-range model
    (dataset_type=0). For nuScenes use `nuscenes()`.
    """

    use_bn_p: bool = True
    use_trans: bool = True

    # --- RGB encoder (identical to the free-point config)
    rgb_encoder_channels: Tuple[Tuple[int, Tuple[int, ...], Tuple[int, ...]], ...] = (
        (3, (16, 16, 16, 16, 32), (2, 1, 1, 1, 2)),
        (32, (32, 32, 32, 32, 64), (2, 1, 1, 1, 2)),
        (64, (64, 64, 64, 64, 128), (1, 1, 1, 1, 2)),
    )

    # --- range image / lidar encoder (ref :21-73)
    init_H: int = 64
    init_W: int = 1800
    fup: float = 2.0
    fdown: float = -24.8
    rank: bool = False  # nearest-wins sorting in projection (ref :25)
    stride_Hs: Tuple[int, ...] = (4, 2, 2, 1)
    stride_Ws: Tuple[int, ...] = (8, 2, 2, 2)
    kernel_sizes: Tuple[Tuple[int, int], ...] = ((9, 15), (9, 15), (5, 9), (5, 9))
    down_conv_dis: Tuple[float, ...] = (0.75, 3.0, 6.0, 12.0)
    lidar_feature_size: int = 7
    using_intens: bool = False
    raw_feat_point: bool = True
    lidar_group_samples: Tuple[int, ...] = (32, 16, 16, 16, 16)
    lidar_encoder_mlps: Tuple[Tuple[int, ...], ...] = (
        (16, 16, 32),
        (32, 32, 64),
        (64, 64, 128),
        (128, 128, 256),
        (128, 64, 64),
    )

    # --- cost volume (ref :92-104)
    cost_volume_dis: Tuple[float, float] = (4.5, 4.5)
    cost_volume_kernel_size: Tuple[Tuple[int, int], ...] = ((3, 5), (3, 5))
    cost_volume_mlps: Tuple[Tuple[int, ...], ...] = ((128, 64, 64), (128, 64))
    cost_volume_nsample: int = 4
    cost_volume_nsamples_q: Tuple[int, int] = (-1, 32)
    backward_validation: Tuple[bool, bool] = (True, False)

    # --- upconv (ref :106-112)
    up_conv_dis: Tuple[float, float] = (9.0, 9.0)
    up_conv_kernel_size: Tuple[Tuple[int, int], ...] = ((5, 9), (5, 9))
    setupconv_mlps: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...] = (
        ((128, 64), (64,)),
        ((128, 64), (64,)),
    )
    setupconv_nsamples: Tuple[int, int] = (8, 8)

    # --- flow predictors / head (ref :113-129)
    flow_predictor_mlps: Tuple[Tuple[int, ...], ...] = ((128, 64), (128, 64), (128, 64))
    head_hidden_dim: int = 256
    rotation_quat_head_dim: int = 4
    transition_vec_head_dim: int = 3
    head_dropout_rate: float = 0.5
    split_dp: bool = False
    max_head: bool = False
    mask_sigmoid: bool = False

    # --- compute dtype for conv/dense stacks ('float32'|'bfloat16'); see
    # I2PNetConfig for these four fields
    compute_dtype: str = "float32"
    encoder_remat: bool = False
    encoder_bn_compute_dtype: bool = True
    spatial_parallel: bool = False

    # reproduce the reference's NaN-row pad scatter (zeroes cell (0, W//2)
    # when the cloud has zero-pad points; see ops.projection.spherical_project)
    ref_pad_quirk: bool = True

    # --- loss (ref :138-146)
    sq_init: float = -2.5
    sx_init: float = 0.0
    l1_trans_loss: bool = True
    focal_mask_loss: bool = True
    focal_gamma: float = 2.0

    # --- iterative refinement (modellearn_proj_center_iter)
    refine_iters: int = 1

    @property
    def lidar_Hs(self) -> Tuple[int, ...]:
        hs, c = [], 1
        for s in self.stride_Hs:
            c *= s
            hs.append(math.ceil(self.init_H / c))
        return tuple(hs)

    @property
    def lidar_Ws(self) -> Tuple[int, ...]:
        ws, c = [], 1
        for s in self.stride_Ws:
            c *= s
            ws.append(math.ceil(self.init_W / c))
        return tuple(ws)

    @classmethod
    def nuscenes(cls) -> "I2PNetProjConfig":
        """dataset_type=1 variant (ref :12, :21, :53-62)."""
        return cls(init_H=32, fup=10.0, fdown=-30.0, stride_Hs=(2, 2, 2, 1))

    @classmethod
    def tiny(cls) -> "I2PNetProjConfig":
        """Small config for tests / multi-chip dry runs."""
        return cls(
            rgb_encoder_channels=(
                (3, (8, 8), (2, 2)),
                (8, (8, 16), (2, 2)),
                (16, (16, 32), (1, 2)),
            ),
            init_H=16,
            init_W=64,
            stride_Hs=(2, 2, 2, 1),
            stride_Ws=(2, 2, 2, 2),
            kernel_sizes=((3, 5), (3, 5), (3, 3), (3, 3)),
            lidar_group_samples=(8, 8, 8, 8, 8),
            lidar_encoder_mlps=((8, 16), (16, 16), (16, 32), (32, 32), (16, 16)),
            cost_volume_kernel_size=((3, 3), (3, 3)),
            cost_volume_mlps=((16, 16), (16, 16)),
            cost_volume_nsamples_q=(-1, 8),
            up_conv_kernel_size=((3, 3), (3, 3)),
            setupconv_mlps=(((16,), (16,)), ((16,), (16,))),
            setupconv_nsamples=(4, 4),
            flow_predictor_mlps=((16, 16), (16, 16), (16, 16)),
            head_hidden_dim=32,
        )


__all__ = ["I2PNetConfig", "I2PNetProjConfig"]
