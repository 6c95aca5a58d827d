"""Real-rig localisation frames ("real_localize", ``params.REAL_DATA``):
the port of ``i2pnet_tpu/data/realloc.py``.

The reference registers this dataset in src/dataset_params.py:156-180
(REAL_DATA) and reads its frames in the visual demo's "realloc" branch
(ref evaluation_vis.py:283-293): ``sequences/<seq>/velodyne/<ts>.bin``
KITTI-format scans and ``sequences/<seq>/images/<ts>.jpg`` camera frames
with one fixed rig intrinsic. The reference's training loader for it is
absent from its snapshot; this module reads the frames the demo needs.
``read_image`` is the one function that decodes a frame (cv2 where it is
installed, else PIL), imported when a frame is read.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from i2pnet_tpu_torch.data.native_io import read_velodyne_bin

# the real rig's camera intrinsic (ref evaluation_vis.py:292-294)
REALLOC_K = np.array(
    [
        [1265.1835, 0.0, 650.6398],
        [0.0, 1265.3955, 536.6536],
        [0.0, 0.0, 1.0],
    ],
    np.float32,
)


def read_image(path: str) -> np.ndarray:
    """A camera frame's file -> (H, W, 3) uint8 RGB: cv2's decode, channels
    reversed, or PIL's where cv2 is not installed."""
    try:
        import cv2
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class RealLocVisDataset:
    """Sequential real-rig frames for the visual demo.

    root layout (ref evaluation_vis.py:286-291):
      <root>/sequences/<seq>/velodyne/<ts>.bin  KITTI velodyne format
      <root>/sequences/<seq>/images/<ts>.jpg    (or .png)

    frames: explicit [(seq, ts), ...]; by default every sequence's velodyne
    directory in sorted order.
    """

    def __init__(self, root: str, frames: Optional[Sequence[Tuple[str, str]]] = None):
        self.root = root
        if frames is None:
            frames = []
            seq_root = os.path.join(root, "sequences")
            for seq in sorted(os.listdir(seq_root)):
                vdir = os.path.join(seq_root, seq, "velodyne")
                if not os.path.isdir(vdir):
                    continue
                for fn in sorted(os.listdir(vdir)):
                    if fn.endswith(".bin"):
                        frames.append((seq, fn[:-4]))
        self.frames: List[Tuple[str, str]] = list(frames)

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, i: int) -> dict:
        seq, ts = self.frames[i]
        xyz, intensity = read_velodyne_bin(
            os.path.join(self.root, "sequences", seq, "velodyne", ts + ".bin"))
        img = None
        for ext in (".jpg", ".png"):
            ip = os.path.join(self.root, "sequences", seq, "images", ts + ext)
            if os.path.exists(ip):
                img = read_image(ip)
                break
        if img is None:
            raise FileNotFoundError(
                os.path.join(self.root, "sequences", seq, "images", ts + ".jpg"))
        return {"seq": seq, "ts": ts, "img": img, "pcl": xyz, "intensity": intensity,
                "K": REALLOC_K.copy()}
