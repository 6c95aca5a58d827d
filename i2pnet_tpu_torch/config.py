"""Model configuration of the port: its own copy of the free-point
``I2PNetConfig`` of ``i2pnet_tpu/config.py``, field for field and default
for default (``tests/test_torch_config.py`` holds the two together), so the
port imports nothing of the JAX package.

A frozen, hashable dataclass; ``tiny()`` is the small test config and
``lidar_layer_points`` the point count of each set-abstraction level.
"""

from __future__ import annotations

import dataclasses
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


__all__ = ["I2PNetConfig"]
