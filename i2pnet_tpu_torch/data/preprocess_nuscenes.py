"""nuScenes offline preprocessing: scene maps, local maps and split lists
(the port of ``i2pnet_tpu/data/preprocess_nuscenes.py``).

Rebuilds the reference's nuScenes pipeline
(data_preprocess/nuScenes_script/gen_maps_our.py:38-522 and
gen_data.py:32-200) with numpy and scipy:

  * scene selection: daytime scenes only (night filtered by description and
    the protocol's fixed test-night token list), LIDAR_TOP frames at
    frame_skip=2 (ref gen_maps_our.py:38-80);
  * the global scene map: each frame's cloud ego-filtered, warped to the
    world by ego_pose @ calibrated_sensor, voxel-downsampled (a numpy
    bincount average for open3d's), then globally voxel-downsampled and
    statistically outlier-filtered (scipy's cKDTree kNN for open3d's)
    (ref :262-302);
  * local maps: the map warped into each frame's nearest key-frame lidar
    frame, cropped to x in (-10, 10), y in (-5, 15), stored as float16
    (4, N) 'PC' and (1, N) 'intensity' h5 datasets with lzf compression
    (ref :354-410), through ``write_local_map``, the one function that
    imports h5py;
  * split lists: pickled [((h5_path, cam_path), K, velo2cam2, extra), ...]
    entries as ``data/nuscenes.py`` reads them (ref :403-414, 419-489), and
    gen_data.py's dataset_info.list (lidar token -> nearby camera tokens of
    all 6 cameras).

Every function takes a ``nusc`` object with the devkit's ``get(table,
token)`` / ``scene`` / ``dataroot`` interface; ``main`` takes the devkit
where it is installed, else ``data/nuscenes_lite.py`` ``NuScenesLite``:

    python3 -m i2pnet_tpu_torch.data.preprocess_nuscenes --nus_folder /nuscenes \
        --output_folder /dataset/nuscenes_processed [--splits train,val,test,info]
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np

# Fixed test-night scene tokens of the evaluation protocol
# (ref gen_maps_our.py:18-35) — protocol data, not code.
TEST_NIGHT_SCENE_TOKENS = frozenset([
    "e59a4d0cc6a84ed59f78fb21a45cdcb4", "7209495d06f24712a063ac6c4a9b403b",
    "3d776ea805f240bb925bd9b50b258416", "48f81c548d0148fc8010a73d70b2ef9c",
    "2ab683f384234dce89800049dec19a30", "7edca4c44eac4f52a3105e1794e56b7e",
    "81c939ce8c0d4cc7b159cb5ed4c4e712", "24e6e64ecf794be4a51f7454c8b6d0b2",
    "828ed34a5e0c456fbf0751cabbab3341", "edfd6cfd1805477fbeadbd29f39ed599",
    "7692a3e112b44b408d191e45954a813c", "58d27a9f83294d99a4ff451dcad5f4d2",
    "a1573aef0bf74324b373dd8a22b4dd68", "ba06095d4e2e425b8e398668abc301d8",
    "7c315a1db2ac49439d281605f3cca6be", "732d7a84353f4ada803a9a115728496c",
    "1630a1d9cf8a46b3843662a23126e3f6", "f437809584344859882bdff7f8784c43",
])

CAM_LIST = ("CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT",
            "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")


def quat_to_rotmat(wxyz) -> np.ndarray:
    """Unit quaternion [w, x, y, z] -> 3x3 rotation (devkit record order)."""
    w, x, y, z = np.asarray(wxyz, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def pose_P(record: dict) -> np.ndarray:
    """ego_pose / calibrated_sensor record -> 4x4 transform
    (ref gen_maps_our.py:98-117 get_P_from_Rt + getters)."""
    P = np.identity(4, np.float32)
    P[:3, :3] = quat_to_rotmat(record["rotation"]).astype(np.float32)
    P[:3, 3] = np.asarray(record["translation"], np.float32)
    return P


def voxel_down_sample(
    points: np.ndarray, attrs: Optional[np.ndarray], voxel_size: float
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Average points (and per-point attributes) per voxel.

    Equivalent of open3d voxel_down_sample (ref gen_maps_our.py:292,297):
    points falling in the same voxel_size cell are averaged. Pure numpy:
    quantize -> unique inverse -> bincount average.
    """
    if points.shape[0] == 0:
        return points, attrs
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    counts = np.bincount(inv).astype(np.float64)
    out = np.stack(
        [np.bincount(inv, weights=points[:, c]) / counts for c in range(3)], 1
    )
    out_attrs = None
    if attrs is not None:
        attrs = attrs.reshape(len(points), -1)
        out_attrs = np.stack(
            [np.bincount(inv, weights=attrs[:, c]) / counts
             for c in range(attrs.shape[1])], 1,
        )
    return out, out_attrs


def remove_statistical_outliers(
    points: np.ndarray, nb_neighbors: int = 40, std_ratio: float = 0.3
) -> np.ndarray:
    """Index mask of inliers, matching open3d remove_statistical_outlier
    (ref gen_maps_our.py:298): drop points whose mean kNN distance exceeds
    mean + std_ratio * std over the cloud."""
    n = len(points)
    if n <= nb_neighbors:
        return np.ones(n, bool)
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    # +1: the query point itself is its own nearest neighbor
    dists, _ = tree.query(points, k=nb_neighbors + 1)
    mean_d = dists[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    return mean_d <= thresh


def get_scene_lidar_tokens(nusc, scene_token: str, frame_skip: int = 2):
    """All LIDAR_TOP sweep tokens of a scene at the given skip
    (ref gen_maps_our.py:38-51)."""
    scene = nusc.get("scene", scene_token)
    first_sample = nusc.get("sample", scene["first_sample_token"])
    lidar = nusc.get("sample_data", first_sample["data"]["LIDAR_TOP"])
    tokens = [lidar["token"]]
    counter = 1
    while lidar["next"] != "":
        lidar = nusc.get("sample_data", lidar["next"])
        counter += 1
        if counter % frame_skip == 0:
            tokens.append(lidar["token"])
    return tokens


def daytime_scenes(nusc, scene_range: Tuple[int, int]):
    """(tokens, names) of non-night scenes in nusc.scene[range]
    (ref gen_maps_our.py:69-80)."""
    tokens, names = [], []
    for scene in nusc.scene[scene_range[0]:scene_range[1]]:
        if ("night" in scene["description"] or "Night" in scene["description"]
                or scene["token"] in TEST_NIGHT_SCENE_TOKENS):
            continue
        tokens.append(scene["token"])
        names.append(scene["name"])
    return tokens, names


def _ego_pose_P(nusc, sample_data):
    return pose_P(nusc.get("ego_pose", sample_data["ego_pose_token"]))


def _calib_P(nusc, sample_data):
    return pose_P(nusc.get("calibrated_sensor",
                           sample_data["calibrated_sensor_token"]))


def load_lidar_sweep(nusc, lidar) -> Tuple[np.ndarray, np.ndarray]:
    """Raw (N, 3) points + (N,) intensity from a LIDAR_TOP .pcd.bin file
    (devkit binary layout: float32 x,y,z,intensity,ring per point)."""
    raw = np.fromfile(
        os.path.join(nusc.dataroot, lidar["filename"]), dtype=np.float32
    ).reshape(-1, 5)
    return raw[:, :3], raw[:, 3]


def filter_ego_points(pc: np.ndarray, intensity: np.ndarray):
    """Drop returns on the ego vehicle: |x| < 0.8 AND |y| < 2.7
    (ref gen_maps_our.py:274-280)."""
    inside = (np.abs(pc[:, 0]) < 0.8) & (np.abs(pc[:, 1]) < 2.7)
    return pc[~inside], intensity[~inside]


def build_scene_map(
    nusc, lidar_tokens: Sequence[str], voxel_size: float = 0.1
) -> Tuple[np.ndarray, np.ndarray]:
    """Accumulate a voxelized world-frame scene map (points (N, 3),
    intensity (N,)) (ref gen_maps_our.py:262-302)."""
    all_pts, all_int = [], []
    for token in lidar_tokens:
        lidar = nusc.get("sample_data", token)
        pc, intensity = load_lidar_sweep(nusc, lidar)
        pc, intensity = filter_ego_points(pc, intensity)
        RT = _ego_pose_P(nusc, lidar) @ _calib_P(nusc, lidar)
        pc_w = pc @ RT[:3, :3].T + RT[:3, 3]
        pts, attrs = voxel_down_sample(pc_w, intensity, voxel_size)
        all_pts.append(pts)
        all_int.append(attrs[:, 0])
    pts = np.concatenate(all_pts, 0)
    intensity = np.concatenate(all_int, 0)
    pts, attrs = voxel_down_sample(pts, intensity, voxel_size)
    keep = remove_statistical_outliers(pts, nb_neighbors=40, std_ratio=0.3)
    return pts[keep].astype(np.float32), attrs[keep, 0].astype(np.float32)


def nearby_camera_tokens(
    nusc, lidar_token: str, max_translation: float, camera_name: str,
    search: bool = False,
):
    """Keyframe camera of the lidar's sample (+ optionally prev/next sweeps
    within max_translation of the lidar pose) (ref gen_data.py:79-137;
    gen_maps_our.py:158-188 ships with the search disabled)."""
    lidar = nusc.get("sample_data", lidar_token)
    lidar_P_inv = np.linalg.inv(_ego_pose_P(nusc, lidar))
    sample = nusc.get("sample", lidar["sample_token"])
    init_token = sample["data"][camera_name]
    tokens = [init_token]
    if not search:
        return tokens
    for direction in ("next", "prev"):
        camera = nusc.get("sample_data", init_token)
        if camera[direction] == "":
            continue
        camera = nusc.get("sample_data", camera[direction])
        while camera[direction] != "":
            camera = nusc.get("sample_data", camera[direction])
            P_lc = lidar_P_inv @ _ego_pose_P(nusc, camera)
            if np.linalg.norm(P_lc[:3, 3]) < max_translation:
                tokens.append(camera["token"])
            else:
                break
    return tokens


def make_dataset_info(nusc, frame_skip: int = 2, max_translation: float = 10.0):
    """gen_data.py's dataset_info entries: (lidar_token, {cam: [tokens]})
    over all daytime scenes and all 6 cameras (ref gen_data.py:140-174)."""
    tokens, _ = daytime_scenes(nusc, (0, len(nusc.scene)))
    dataset = []
    for scene_token in tokens:
        for lidar_token in get_scene_lidar_tokens(nusc, scene_token, frame_skip):
            cams = {
                cam: nearby_camera_tokens(
                    nusc, lidar_token, max_translation, cam, search=True
                )
                for cam in CAM_LIST
            }
            dataset.append((lidar_token, cams))
    return dataset


def write_local_map(path: str, pc: np.ndarray, intensity: np.ndarray) -> None:
    """One local map as h5: float16 datasets 'PC' (4, N) and 'intensity'
    (1, N), lzf-compressed and shuffled (ref gen_maps_our.py:403-410)."""
    import h5py

    with h5py.File(path, "w") as hf:
        hf.create_dataset("PC", data=pc, compression="lzf", shuffle=True)
        hf.create_dataset("intensity", data=intensity, compression="lzf", shuffle=True)


def generate_scene(
    nusc,
    scene_name: str,
    scene_token: str,
    output_folder: str,
    rng: np.random.Generator,
    voxel_size: float = 0.1,
    frame_skip: int = 2,
    version: str = "0.1",
    relative_paths: bool = True,
):
    """One scene: build (or reuse) its map, emit per-frame local-map h5s,
    return datasplit entries (ref gen_maps_our.py:238-416).

    relative_paths stores h5 paths relative to output_folder so the output
    tree is relocatable (the reference stores absolute paths; os.path.join
    in the loaders accepts both)."""
    scene_dir = os.path.join(output_folder, "sequences", scene_name)
    map_dir = os.path.join(scene_dir, "map")
    local_dir = os.path.join(scene_dir, f"local_maps_small_{version}")
    os.makedirs(map_dir, exist_ok=True)
    os.makedirs(local_dir, exist_ok=True)

    lidar_tokens = get_scene_lidar_tokens(nusc, scene_token, frame_skip)

    map_path = os.path.join(map_dir, f"map-{scene_name}_{voxel_size}.npz")
    if os.path.exists(map_path):
        cached = np.load(map_path)
        map_pts, map_int = cached["points"], cached["intensity"]
    else:
        map_pts, map_int = build_scene_map(nusc, lidar_tokens, voxel_size)
        np.savez_compressed(map_path, points=map_pts, intensity=map_int)

    map_h = np.concatenate(
        [map_pts, np.ones((len(map_pts), 1), np.float32)], 1
    )  # (N, 4)

    entries = []
    for i, lidar_token in enumerate(lidar_tokens):
        cam_tokens = nearby_camera_tokens(nusc, lidar_token, 5.0, "CAM_FRONT")
        cam = nusc.get("sample_data",
                       cam_tokens[int(rng.integers(len(cam_tokens)))])
        camera_P = _ego_pose_P(nusc, cam)
        camera_CP = _calib_P(nusc, cam)
        camera_K = nusc.get(
            "calibrated_sensor", cam["calibrated_sensor_token"]
        )["camera_intrinsic"]

        # the pose/extrinsic anchor is the keyframe lidar of the chosen
        # camera's sample, not the sweep itself (ref gen_maps_our.py:345-352)
        cam_sample = nusc.get("sample", cam["sample_token"])
        near_lidar = nusc.get("sample_data", cam_sample["data"]["LIDAR_TOP"])
        near_world = _ego_pose_P(nusc, near_lidar) @ _calib_P(nusc, near_lidar)
        near_pose = np.linalg.inv(near_world)
        velo2cam2 = (
            np.linalg.inv(camera_CP) @ np.linalg.inv(camera_P) @ near_world
        )

        local = map_h @ near_pose.T  # (N, 4) in the near-lidar frame
        keep = (
            (local[:, 0] > -10.0) & (local[:, 0] < 10.0)
            & (local[:, 1] > -5.0) & (local[:, 1] < 15.0)
        )  # ref gen_maps_our.py:361-366
        local = local[keep].T  # (4, M)
        local_int = map_int[keep][None, :]  # (1, M)

        h5_path = os.path.join(local_dir, f"{i:06d}.h5")
        write_local_map(h5_path, local.astype(np.float16), local_int.astype(np.float16))

        stored = (os.path.relpath(h5_path, output_folder)
                  if relative_paths else h5_path)
        # extra layout matches the reference exactly: slots 2-3 carry the
        # SWEEP lidar's calib/pose (ref gen_maps_our.py:322-323,411),
        # which differs from near_lidar whenever frame_skip > 1
        lidar_sd = nusc.get("sample_data", lidar_token)
        extra = [camera_P, camera_CP, _calib_P(nusc, lidar_sd),
                 _ego_pose_P(nusc, lidar_sd), near_world, scene_name]
        # camera images live in the nuScenes dataroot (not the output
        # tree) -> store them absolute; h5 paths stay relative to
        # output_folder so the generated tree itself is relocatable
        cam_stored = os.path.join(nusc.dataroot, cam["filename"])
        entries.append(
            ((stored, cam_stored),
             np.asarray(camera_K, np.float64),
             velo2cam2.astype(np.float32), extra)
        )
    return entries


def generate_split(
    nusc,
    output_folder: str,
    scene_range: Tuple[int, int],
    n_scenes: int,
    list_name: str,
    seed: int = 0,
    voxel_size: float = 0.1,
    frame_skip: int = 2,
):
    """Select n_scenes daytime scenes from the range, process them and dump
    the pickled datasplit (ref gen_maps_our.py:419-489 main/main_val/test)."""
    rng = np.random.default_rng(seed)
    tokens, names = daytime_scenes(nusc, scene_range)
    n_scenes = min(n_scenes, len(tokens))
    sel = rng.choice(len(tokens), n_scenes, replace=False)
    dataset = []
    for idx in sel:
        dataset.extend(
            generate_scene(nusc, names[idx], tokens[idx], output_folder, rng,
                           voxel_size=voxel_size, frame_skip=frame_skip)
        )
    os.makedirs(output_folder, exist_ok=True)
    out_path = os.path.join(output_folder, list_name)
    with open(out_path, "wb") as f:
        pickle.dump(dataset, f)
    return out_path, len(dataset)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="nuScenes map + datasplit generation (a rebuild of the "
        "reference's gen_maps_our.py / gen_data.py on numpy and scipy)"
    )
    ap.add_argument("--nus_folder", required=True,
                    help="nuScenes root (contains trainval/ and test/)")
    ap.add_argument("--output_folder", required=True)
    ap.add_argument("--voxel_size", type=float, default=0.1)
    ap.add_argument("--frame_skip", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--splits", default="train,val,test",
                    help="comma subset of train,val,test,info")
    args = ap.parse_args(argv)

    try:
        from nuscenes.nuscenes import NuScenes
    except ImportError:
        # self-contained fallback: read the v1.0 JSON tables directly —
        # same schema, same derived reverse index (data/nuscenes_lite.py);
        # the devkit is only preferred when installed for byte-level
        # compatibility with its own loaders
        from i2pnet_tpu_torch.data.nuscenes_lite import NuScenesLite as NuScenes

    wanted = set(args.splits.split(","))
    # split protocol: train = 70 of scenes [0, 700), val = 6 of [700, 850),
    # test = 13 of the v1.0-test scenes (ref gen_maps_our.py:419-489)
    if wanted & {"train", "val", "info"}:
        nusc = NuScenes(version="v1.0-trainval",
                        dataroot=os.path.join(args.nus_folder, "trainval"))
        if "train" in wanted:
            p, n = generate_split(
                nusc, args.output_folder, (0, 700), 70,
                "train_dataset_map_small_short.list",
                seed=args.seed, voxel_size=args.voxel_size,
                frame_skip=args.frame_skip)
            print(f"train: {n} entries -> {p}")
        if "val" in wanted:
            p, n = generate_split(
                nusc, args.output_folder, (700, 850), 6,
                "val_dataset_map_demo.list",
                seed=args.seed + 1, voxel_size=args.voxel_size,
                frame_skip=args.frame_skip)
            print(f"val: {n} entries -> {p}")
        if "info" in wanted:
            info = make_dataset_info(nusc, args.frame_skip)
            out = os.path.join(args.output_folder, "dataset_info.list")
            with open(out, "wb") as f:
                pickle.dump(info, f)
            print(f"info: {len(info)} entries -> {out}")
    if "test" in wanted:
        nusc = NuScenes(version="v1.0-test",
                        dataroot=os.path.join(args.nus_folder, "test"))
        p, n = generate_split(
            nusc, args.output_folder, (0, 150), 13,
            "test_dataset_map_small_short.list",
            seed=args.seed + 2, voxel_size=args.voxel_size,
            frame_skip=args.frame_skip)
        print(f"test: {n} entries -> {p}")


if __name__ == "__main__":
    main()
