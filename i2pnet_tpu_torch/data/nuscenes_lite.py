"""Self-contained nuScenes table reader (devkit-lite): the port of
``i2pnet_tpu/data/nuscenes_lite.py``.

Loads the nuScenes v1.0 JSON tables straight from disk and exposes the
subset of the ``nuscenes-devkit`` interface that the offline
preprocessing (``data/preprocess_nuscenes.py``) consumes:

  * ``get(table, token)``: token-keyed record lookup;
  * ``scene``: the scene table as a list;
  * ``dataroot``: the root holding the version dir and the data files;
  * the devkit's derived fields: the ``sample["data"][channel]`` reverse
    index over KEY-FRAME sample_datas, and ``channel`` /
    ``sensor_modality`` injected into each sample_data record (nuscenes-
    devkit ``NuScenes.__make_reverse_index__`` semantics).

Field conventions follow the published v1.0 schema (the one the devkit
parses): ``ego_pose.rotation`` / ``calibrated_sensor.rotation`` are
[w, x, y, z] quaternions, translations [x, y, z] meters, and
``calibrated_sensor.camera_intrinsic`` is [] for non-camera sensors. The
standard library only, so the preprocessing runs where the devkit is not
installed, and a drop-in for an installed devkit object.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

TABLES = (
    "scene",
    "sample",
    "sample_data",
    "ego_pose",
    "calibrated_sensor",
    "sensor",
    "log",
)


class NuScenesLite:
    """Reads <dataroot>/<version>/*.json (real nuScenes table layout)."""

    def __init__(self, dataroot: str, version: str = "v1.0-trainval"):
        self.dataroot = dataroot
        self.version = version
        table_dir = os.path.join(dataroot, version)
        self._tables: Dict[str, Dict[str, dict]] = {}
        self._lists: Dict[str, List[dict]] = {}
        for name in TABLES:
            path = os.path.join(table_dir, f"{name}.json")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"nuScenes table missing: {path} (need the v1.0 JSON "
                    f"tables under {table_dir})"
                )
            with open(path) as f:
                records = json.load(f)
            self._lists[name] = records
            self._tables[name] = {r["token"]: r for r in records}
        self.scene = self._lists["scene"]
        self._make_reverse_index()

    def _make_reverse_index(self) -> None:
        """devkit NuScenes.__make_reverse_index__ subset: channel /
        sensor_modality on sample_data; sample['data'] over key frames."""
        for sample in self._lists["sample"]:
            sample.setdefault("data", {})
        for sd in self._lists["sample_data"]:
            cs = self._tables["calibrated_sensor"][sd["calibrated_sensor_token"]]
            sensor = self._tables["sensor"][cs["sensor_token"]]
            sd["channel"] = sensor["channel"]
            sd["sensor_modality"] = sensor["modality"]
            if sd.get("is_key_frame"):
                self._tables["sample"][sd["sample_token"]]["data"][
                    sensor["channel"]
                ] = sd["token"]

    def get(self, table: str, token: str) -> dict:
        return self._tables[table][token]

    def __repr__(self) -> str:  # parity with devkit's str output shape
        return f"NuScenesLite(version={self.version!r}, dataroot={self.dataroot!r})"
