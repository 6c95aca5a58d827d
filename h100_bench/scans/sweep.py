"""``sweep``: one spinning-LiDAR sweep in the LiDAR frame: ``beams`` rings
spread evenly over the configuration's elevation field (its model's
``fdown``, ``fup``), each firing at a fixed azimuth step over the full
circle from a random phase, ranges uniform in ``near_m`` (a
``1 - far_share`` of them) and in ``far_m``; ``real_points`` real, the
rest of ``points`` zero padding, as the large-range loader pads a scan.
The model sees ``Pr Tr X`` with one uniform intensity a point."""

from __future__ import annotations

import math

import numpy as np

from ..gen import VELO_TO_CAM, ranges


def sweep_scan(rng, real: int, spec: dict, fup: float, fdown: float) -> np.ndarray:
    """(real, 3) LiDAR-frame points of one sweep (module docstring)."""
    beams = spec["beams"]
    per = real // beams
    if per * beams != real:
        raise ValueError(f"sweep_scan: {real} points do not split into {beams} beams")
    el = np.radians(fdown + (np.arange(beams) + 0.5) * (fup - fdown) / beams)
    phase = rng.uniform(0, 2 * math.pi / per, beams)
    az = phase[:, None] + np.arange(per)[None, :] * (2 * math.pi / per)
    el = np.broadcast_to(el[:, None], az.shape)
    r = ranges(rng, real, spec).reshape(beams, per)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], -1)
    # the loader permutes a scan's points; the last one in a cell wins it
    return pts.reshape(real, 3)[rng.permutation(real)]


def points(rng, config: dict, scan: dict, Pr: np.ndarray):
    """(lidar, features, raw) of one pair."""
    total, real, mc = config["points"], config["real_points"], config["model"]
    raw = np.zeros((total, 3))
    raw[:real] = sweep_scan(rng, real, scan, mc["fup"], mc["fdown"])
    E = Pr[:3, :3] @ VELO_TO_CAM
    lidar = np.zeros((total, 3))
    lidar[:real] = raw[:real] @ E.T + Pr[:3, 3]
    feats = np.zeros((total, 1))
    feats[:real, 0] = rng.uniform(0, 1, real)
    return lidar, feats, raw
