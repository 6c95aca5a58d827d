"""The nuScenes offline preprocessing of the port
(``i2pnet_tpu_torch/data/preprocess_nuscenes.py``, ``data/nuscenes_lite.py``)
against the JAX package's on the same inputs, on the CPU: every function's
result bit for bit, the local-map h5 files, the scene-map npz entries and
the pickled split lists byte for byte, ``NuScenesLite``'s tables and reverse
index, and ``main`` on a v1.0 JSON tree; then the port's loaders read the
split. The fixtures are tests/test_preprocess_nuscenes.py's, copied here: a
schema-faithful devkit stub and real v1.0 JSON tables on disk with
non-identity rotations."""

import os
import pickle

import h5py
import numpy as np
import pytest

from i2pnet_tpu.data import preprocess_nuscenes as JPN
from i2pnet_tpu.data.nuscenes_lite import NuScenesLite as JaxLite
from i2pnet_tpu_torch.data import NuScenesCMRDataset, NuScenesLargeRangeDataset
from i2pnet_tpu_torch.data import preprocess_nuscenes as PN
from i2pnet_tpu_torch.data.nuscenes_lite import NuScenesLite


class StubNuScenes:
    """Minimal devkit stand-in: token-keyed tables + dataroot."""

    def __init__(self, dataroot, tables):
        self.dataroot = dataroot
        self._tables = tables
        self.scene = tables["scene_list"]

    def get(self, table, token):
        return self._tables[table][token]


def _quat_identity():
    return [1.0, 0.0, 0.0, 0.0]


@pytest.fixture(scope="module")
def stub_nusc(tmp_path_factory):
    root = tmp_path_factory.mktemp("nusc_raw")
    rng = np.random.default_rng(0)
    tables = {
        "scene_list": [],
        "scene": {},
        "sample": {},
        "sample_data": {},
        "ego_pose": {},
        "calibrated_sensor": {},
    }

    (root / "sweeps").mkdir()
    (root / "cams").mkdir()
    from PIL import Image

    def add_scene(name, description, n_frames):
        lidar_tokens = [f"{name}_L{i}" for i in range(n_frames)]
        for i, tok in enumerate(lidar_tokens):
            # sweep file: float32 (x, y, z, intensity, ring) rows
            pts = rng.uniform(-8, 8, size=(500, 3)).astype(np.float32)
            pts[:40, 0] = rng.uniform(-0.5, 0.5, 40)  # ego-vehicle returns
            pts[:40, 1] = rng.uniform(-2.0, 2.0, 40)
            raw = np.concatenate(
                [pts, rng.uniform(0, 1, (500, 1)).astype(np.float32),
                 np.zeros((500, 1), np.float32)], 1,
            )
            raw.tofile(root / "sweeps" / f"{tok}.pcd.bin")

            img = Image.fromarray(
                rng.integers(0, 255, size=(200, 300, 3), dtype=np.uint8)
            )
            img.save(root / "cams" / f"{name}_C{i}.jpg")

            tables["ego_pose"][f"ep_{tok}"] = {
                "rotation": _quat_identity(),
                "translation": [float(i) * 0.5, 0.0, 0.0],
            }
            tables["calibrated_sensor"][f"cs_{tok}"] = {
                "rotation": _quat_identity(),
                "translation": [0.0, 0.0, 1.8],
            }
            tables["ego_pose"][f"ep_{name}_C{i}"] = {
                "rotation": _quat_identity(),
                "translation": [float(i) * 0.5 + 0.1, 0.0, 0.0],
            }
            tables["calibrated_sensor"][f"cs_{name}_C{i}"] = {
                "rotation": _quat_identity(),
                "translation": [0.0, 0.0, 1.5],
                "camera_intrinsic": [[120.0, 0.0, 150.0],
                                     [0.0, 120.0, 100.0],
                                     [0.0, 0.0, 1.0]],
            }
            sample_tok = f"{name}_S{i}"
            cam_tok = f"{name}_C{i}"
            tables["sample"][sample_tok] = {
                "token": sample_tok,
                "data": {"LIDAR_TOP": tok,
                         **{c: cam_tok for c in PN.CAM_LIST}},
            }
            tables["sample_data"][tok] = {
                "token": tok,
                "sample_token": sample_tok,
                "ego_pose_token": f"ep_{tok}",
                "calibrated_sensor_token": f"cs_{tok}",
                "filename": f"sweeps/{tok}.pcd.bin",
                "next": lidar_tokens[i + 1] if i + 1 < n_frames else "",
            }
            tables["sample_data"][cam_tok] = {
                "token": cam_tok,
                "sample_token": sample_tok,
                "ego_pose_token": f"ep_{name}_C{i}",
                "calibrated_sensor_token": f"cs_{name}_C{i}",
                "filename": f"cams/{name}_C{i}.jpg",
                "next": "", "prev": "",
            }
        scene = {
            "token": f"scene_{name}",
            "name": name,
            "description": description,
            "first_sample_token": f"{name}_S0",
        }
        tables["scene"][scene["token"]] = scene
        tables["scene_list"].append(scene)

    add_scene("day0", "sunny drive", 4)
    add_scene("night0", "Night drive", 4)
    return StubNuScenes(str(root), tables)


def _wxyz(rot) -> list:
    """scipy Rotation -> schema-order [w, x, y, z] quaternion list."""
    x, y, z, w = rot.as_quat()
    return [float(w), float(x), float(y), float(z)]


def _P_from_record(rec: dict) -> np.ndarray:
    """Independent oracle: 4x4 pose from a raw table record, decoding the
    schema's [w,x,y,z] rotation with scipy (NOT the code under test)."""
    from scipy.spatial.transform import Rotation

    q = rec["rotation"]
    R = Rotation.from_quat([q[1], q[2], q[3], q[0]]).as_matrix()
    P = np.eye(4)
    P[:3, :3] = R
    P[:3, 3] = rec["translation"]
    return P


@pytest.fixture(scope="module")
def json_nusc(tmp_path_factory):
    """On-disk nuScenes v1.0 fixture: real JSON table schema (wxyz
    rotations, is_key_frame, prev/next chains, sensor/log tables, real
    file layout) with NON-identity rotations so a quaternion-order misread
    cannot hide, plus intermediate non-key-frame sweeps so the devkit's
    key-frame-only reverse index is exercised."""
    import json as jsonlib

    from PIL import Image
    from scipy.spatial.transform import Rotation

    root = tmp_path_factory.mktemp("nusc_json")
    (root / "samples" / "LIDAR_TOP").mkdir(parents=True)
    (root / "sweeps" / "LIDAR_TOP").mkdir(parents=True)
    (root / "samples" / "CAM_FRONT").mkdir(parents=True)
    tdir = root / "v1.0-trainval"
    tdir.mkdir()

    rng = np.random.default_rng(7)
    yaw = Rotation.from_euler("z", 0.3)
    lidar_cs_rot = Rotation.identity()
    # front camera mount: cam x=right, y=down, z=forward in an ego frame
    # with x=forward, y=left, z=up
    cam_cs_R = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    cam_cs_rot = Rotation.from_matrix(cam_cs_R)

    sensors = [
        {"token": "sen_lidar", "channel": "LIDAR_TOP", "modality": "lidar"},
    ]
    for c in PN.CAM_LIST:
        sensors.append({"token": f"sen_{c}", "channel": c, "modality": "camera"})
    logs = [{"token": "log0", "logfile": "n008", "vehicle": "n008",
             "date_captured": "2018-08-01", "location": "boston-seaport"}]

    scenes, samples, sample_datas, ego_poses, calib_sensors = [], [], [], [], []
    marker = np.array([6.5, 5.0, 2.0], np.float32)

    def write_sweep(path, include_marker):
        pts = rng.uniform([-8, -8, -1], [4, 8, 3], size=(500, 3)).astype(np.float32)
        pts[:40, 0] = rng.uniform(-0.5, 0.5, 40)  # ego returns (filtered)
        pts[:40, 1] = rng.uniform(-2.0, 2.0, 40)
        if include_marker:
            # a CLUSTER bigger than the outlier filter's 40-NN window so
            # the map keeps it (an isolated point would be dropped by
            # design)
            pts[-150:] = marker + rng.normal(0, 0.25, size=(150, 3)).astype(
                np.float32)
        raw = np.concatenate(
            [pts, rng.uniform(0, 1, (500, 1)).astype(np.float32),
             np.zeros((500, 1), np.float32)], 1)
        raw.astype(np.float32).tofile(path)

    def add_scene(name, description, night=False):
        n_key = 4
        t0 = 1_533_100_000_000_000
        key_lidar = [f"{name}_L{i}" for i in range(n_key)]
        mid_lidar = [f"{name}_M{i}" for i in range(n_key - 1)]
        chain = []
        for i in range(n_key):
            chain.append(key_lidar[i])
            if i < n_key - 1:
                chain.append(mid_lidar[i])
        for i in range(n_key):
            samples.append({
                "token": f"{name}_S{i}",
                "timestamp": t0 + i * 500_000,
                "prev": f"{name}_S{i-1}" if i else "",
                "next": f"{name}_S{i+1}" if i + 1 < n_key else "",
                "scene_token": f"scene_{name}",
            })
        for j, tok in enumerate(chain):
            is_key = tok in key_lidar
            i_key = int(tok[len(name) + 2:])
            # non-key sweep associated with the NEXT keyframe's sample,
            # like real data
            sample_tok = (f"{name}_S{i_key}" if is_key
                          else f"{name}_S{i_key + 1}")
            x = 0.25 * j  # ego marches in world x
            ego_poses.append({
                "token": f"ep_{tok}",
                "timestamp": t0 + j * 250_000,
                "rotation": _wxyz(yaw),
                "translation": [x, 0.0, 0.0],
            })
            calib_sensors.append({
                "token": f"cs_{tok}",
                "sensor_token": "sen_lidar",
                "translation": [0.0, 0.0, 1.8],
                "rotation": _wxyz(lidar_cs_rot),
                "camera_intrinsic": [],
            })
            sub = "samples" if is_key else "sweeps"
            fn = f"{sub}/LIDAR_TOP/{tok}.pcd.bin"
            write_sweep(root / fn, include_marker=(tok == f"{name}_M0"))
            sample_datas.append({
                "token": tok,
                "sample_token": sample_tok,
                "ego_pose_token": f"ep_{tok}",
                "calibrated_sensor_token": f"cs_{tok}",
                "timestamp": t0 + j * 250_000,
                "fileformat": "pcd",
                "is_key_frame": is_key,
                "height": 0,
                "width": 0,
                "filename": fn,
                "prev": chain[j - 1] if j else "",
                "next": chain[j + 1] if j + 1 < len(chain) else "",
            })
        for c in PN.CAM_LIST:
            for i in range(n_key):
                tok = f"{name}_{c}_{i}"
                ego_poses.append({
                    "token": f"ep_{tok}",
                    "timestamp": t0 + i * 500_000 + 20_000,
                    "rotation": _wxyz(yaw),
                    "translation": [0.5 * i + 0.1, 0.0, 0.0],
                })
                calib_sensors.append({
                    "token": f"cs_{tok}",
                    "sensor_token": f"sen_{c}",
                    "translation": [1.5, 0.0, 1.5],
                    "rotation": _wxyz(cam_cs_rot),
                    "camera_intrinsic": [[120.0, 0.0, 150.0],
                                         [0.0, 120.0, 100.0],
                                         [0.0, 0.0, 1.0]],
                })
                fn = f"samples/CAM_FRONT/{tok}.jpg"
                Image.fromarray(rng.integers(
                    0, 255, size=(200, 300, 3), dtype=np.uint8)).save(root / fn)
                sample_datas.append({
                    "token": tok,
                    "sample_token": f"{name}_S{i}",
                    "ego_pose_token": f"ep_{tok}",
                    "calibrated_sensor_token": f"cs_{tok}",
                    "timestamp": t0 + i * 500_000 + 20_000,
                    "fileformat": "jpg",
                    "is_key_frame": True,
                    "height": 200,
                    "width": 300,
                    "filename": fn,
                    "prev": f"{name}_{c}_{i-1}" if i else "",
                    "next": f"{name}_{c}_{i+1}" if i + 1 < n_key else "",
                })
        scenes.append({
            "token": f"scene_{name}",
            "log_token": "log0",
            "nbr_samples": n_key,
            "first_sample_token": f"{name}_S0",
            "last_sample_token": f"{name}_S{n_key-1}",
            "name": name,
            "description": description,
        })

    add_scene("scene-0001", "Parked truck, sunny")
    add_scene("scene-0002", "Night drive, empty road")

    tables = {
        "scene": scenes, "sample": samples, "sample_data": sample_datas,
        "ego_pose": ego_poses, "calibrated_sensor": calib_sensors,
        "sensor": sensors, "log": logs,
    }
    for name, records in tables.items():
        with open(tdir / f"{name}.json", "w") as f:
            jsonlib.dump(records, f)
    return str(root), marker




def _same_h5(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:  # h5py writes no time stamps
        assert fa.read() == fb.read(), a
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        for key in ("PC", "intensity"):
            assert fa[key].dtype == fb[key].dtype == np.float16
            assert fa[key].compression == fb[key].compression == "lzf" and fa[key].shuffle
            np.testing.assert_array_equal(np.asarray(fa[key]), np.asarray(fb[key]))


def _same(a, b) -> None:
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("q", [[1.0, 0, 0, 0], [0.9, 0.1, -0.3, 0.2], [0, 0, 0, 0]],
                         ids=["identity", "rotation", "zero"])
def test_quat_and_pose_equal_jax(q):
    np.testing.assert_array_equal(PN.quat_to_rotmat(q), JPN.quat_to_rotmat(q))
    rec = {"rotation": q, "translation": [1.5, -2.0, 0.25]}
    np.testing.assert_array_equal(PN.pose_P(rec), JPN.pose_P(rec))


@pytest.mark.parametrize("attrs", [True, False], ids=["attrs", "points"])
def test_voxel_down_sample_equals_jax(attrs):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, size=(4000, 3))
    a = rng.uniform(0, 1, size=(4000, 2)) if attrs else None
    got, ref = PN.voxel_down_sample(pts, a, 0.2), JPN.voxel_down_sample(pts, a, 0.2)
    _same(got, ref)
    _same(PN.voxel_down_sample(pts[:0], None, 0.2), JPN.voxel_down_sample(pts[:0], None, 0.2))
    # the JAX test's cells
    out, at = PN.voxel_down_sample(np.array([[0.01, 0.01, 0.01], [0.04, 0.04, 0.04],
                                             [1.0, 1.0, 1.0]]), np.array([1.0, 3.0, 5.0]), 0.1)
    assert out.shape == (2, 3) and sorted(at[:, 0]) == [2.0, 5.0]


@pytest.mark.parametrize("n", [30, 301], ids=["fewer_than_k", "cloud"])
def test_outlier_removal_equals_jax(n):
    rng = np.random.default_rng(0)
    cloud = np.concatenate([rng.normal(size=(n - 1, 3)) * 0.5, [[50.0, 50.0, 50.0]]], 0)
    got = PN.remove_statistical_outliers(cloud, nb_neighbors=20, std_ratio=1.0)
    np.testing.assert_array_equal(got, JPN.remove_statistical_outliers(cloud, 20, 1.0))
    if n > 21:
        assert not got[-1] and got[:-1].mean() > 0.8


def test_scene_selection_equals_jax(stub_nusc):
    assert PN.daytime_scenes(stub_nusc, (0, 10)) == JPN.daytime_scenes(stub_nusc, (0, 10))
    tokens, names = PN.daytime_scenes(stub_nusc, (0, 10))
    assert names == ["day0"]
    for skip in (1, 2, 3):
        assert PN.get_scene_lidar_tokens(stub_nusc, tokens[0], skip) == \
            JPN.get_scene_lidar_tokens(stub_nusc, tokens[0], skip)
    assert PN.get_scene_lidar_tokens(stub_nusc, tokens[0], 2) == ["day0_L0", "day0_L1", "day0_L3"]
    assert PN.TEST_NIGHT_SCENE_TOKENS == JPN.TEST_NIGHT_SCENE_TOKENS
    assert PN.CAM_LIST == JPN.CAM_LIST


def test_sweeps_and_ego_filter_equal_jax(stub_nusc):
    lidar = stub_nusc.get("sample_data", "day0_L1")
    pc, inten = PN.load_lidar_sweep(stub_nusc, lidar)
    _same((pc, inten), JPN.load_lidar_sweep(stub_nusc, lidar))
    _same(PN.filter_ego_points(pc, inten), JPN.filter_ego_points(pc, inten))
    assert len(PN.filter_ego_points(pc, inten)[0]) < len(pc)


def test_dataset_info_equals_jax(stub_nusc):
    info = PN.make_dataset_info(stub_nusc, frame_skip=2)
    assert info == JPN.make_dataset_info(stub_nusc, frame_skip=2)
    assert len(info) == 3 and set(info[0][1]) == set(PN.CAM_LIST)


@pytest.fixture(scope="module")
def lite(json_nusc):
    return NuScenesLite(json_nusc[0], version="v1.0-trainval")


def test_nuscenes_lite_equals_jax(json_nusc, lite):
    ref = JaxLite(json_nusc[0], version="v1.0-trainval")
    assert lite.scene == ref.scene and lite.dataroot == ref.dataroot
    assert lite._lists == ref._lists and lite._tables == ref._tables
    s0 = lite.get("sample", "scene-0001_S0")
    assert s0["data"]["LIDAR_TOP"] == "scene-0001_L0" and set(PN.CAM_LIST) <= set(s0["data"])
    assert lite.get("sample_data", "scene-0001_M0")["sensor_modality"] == "lidar"
    assert repr(lite).startswith("NuScenesLite(")
    with pytest.raises(FileNotFoundError, match="v1.0-mini"):
        NuScenesLite(json_nusc[0], version="v1.0-mini")


@pytest.mark.parametrize("search", [False, True])
def test_nearby_cameras_equal_jax(lite, search):
    for tok in ("scene-0001_L0", "scene-0001_L2"):
        assert PN.nearby_camera_tokens(lite, tok, 5.0, "CAM_FRONT", search) == \
            JPN.nearby_camera_tokens(lite, tok, 5.0, "CAM_FRONT", search)


def test_scene_map_equals_jax(lite):
    tokens = PN.get_scene_lidar_tokens(lite, "scene_scene-0001", 2)
    _same(PN.build_scene_map(lite, tokens, 0.2), JPN.build_scene_map(lite, tokens, 0.2))


def _generate(module, nusc, out, **kw):
    return module.generate_split(nusc, out, (0, 10), 1, "train_dataset_map_small_short.list",
                                 seed=0, voxel_size=0.2, **kw)


def _same_trees(a: str, b: str) -> None:
    """The same files under both roots: h5 and pickles byte for byte, the
    scene maps' npz entries."""
    files = []
    for base, _, names in os.walk(a):
        files += [os.path.relpath(os.path.join(base, n), a) for n in names]
    other = []
    for base, _, names in os.walk(b):
        other += [os.path.relpath(os.path.join(base, n), b) for n in names]
    assert sorted(files) == sorted(other) and files
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".h5"):
            _same_h5(pa, pb)
        elif rel.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert za.files == zb.files and all(np.array_equal(za[k], zb[k]) for k in za.files)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("which", ["stub", "json"])
def test_generate_split_equals_jax(which, stub_nusc, lite, tmp_path):
    nusc = stub_nusc if which == "stub" else lite
    path, n = _generate(PN, nusc, str(tmp_path / "port"))
    jpath, jn = _generate(JPN, nusc, str(tmp_path / "jax"))
    assert n == jn == (3 if which == "stub" else 4)
    _same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    with open(path, "rb") as f:
        entries = pickle.load(f)
    (h5_rel, cam), K, velo2cam2, extra = entries[0]
    assert not os.path.isabs(h5_rel) and os.path.isabs(cam)
    assert np.asarray(K).shape == (3, 3) and np.asarray(velo2cam2).shape == (4, 4)
    # a second run reuses the cached scene map and gives the same files
    _generate(PN, nusc, str(tmp_path / "port"))
    _same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_generate_scene_writes_through_one_function(stub_nusc, tmp_path, monkeypatch):
    """Every local map goes through write_local_map, the one h5py call."""
    written = []
    monkeypatch.setattr(PN, "write_local_map", lambda p, pc, i: written.append((p, pc, i)))
    entries = PN.generate_scene(stub_nusc, "day0", "scene_day0", str(tmp_path), np.random.
                                default_rng(0), voxel_size=0.2)
    assert len(written) == len(entries) == 3
    assert all(pc.dtype == i.dtype == np.float16 and pc.shape[0] == 4 for _, pc, i in written)


def test_main_equals_jax(json_nusc, tmp_path):
    """main on <nus_folder>/trainval (the v1.0 JSON tables; no devkit here,
    so NuScenesLite) writes the train list and dataset_info.list as JAX's
    main does."""
    root, _ = json_nusc
    nus = tmp_path / "nus"
    nus.mkdir()
    os.symlink(root, str(nus / "trainval"))
    for name, module in (("port", PN), ("jax", JPN)):
        module.main(["--nus_folder", str(nus), "--output_folder", str(tmp_path / name),
                     "--voxel_size", "0.2", "--splits", "train,info"])
    _same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert sorted(f for f in os.listdir(str(tmp_path / "port")) if f.endswith(".list")) == [
        "dataset_info.list", "train_dataset_map_small_short.list"]


def test_generated_split_feeds_the_loaders(json_nusc, lite, tmp_path):
    """The port's nuScenes loaders read the port's split as JAX's loaders
    read JAX's (geometry: the velo2cam2 oracle from the raw records)."""
    from i2pnet_tpu.data import NuScenesCMRDataset as JaxCMR

    root, _ = json_nusc
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    path, _ = _generate(PN, lite, out)
    jpath, _ = _generate(JPN, lite, jout)
    with open(path, "rb") as f:
        (h5_rel, cam_rel), K, velo2cam2, extra = pickle.load(f)[0]
    cam_tok = os.path.basename(cam_rel)[:-4]
    sd_cam = lite.get("sample_data", cam_tok)
    sd_near = lite.get("sample_data", lite.get("sample", sd_cam["sample_token"])["data"]
                       ["LIDAR_TOP"])
    want = (np.linalg.inv(_P_from_record(lite.get("calibrated_sensor",
                                                  sd_cam["calibrated_sensor_token"])))
            @ np.linalg.inv(_P_from_record(lite.get("ego_pose", sd_cam["ego_pose_token"])))
            @ _P_from_record(lite.get("ego_pose", sd_near["ego_pose_token"]))
            @ _P_from_record(lite.get("calibrated_sensor", sd_near["calibrated_sensor_token"])))
    np.testing.assert_allclose(np.asarray(velo2cam2), want, atol=1e-5)
    for base in (out, jout):
        for d in ("samples", "sweeps"):
            os.symlink(os.path.join(root, d), os.path.join(base, d))
    ours = NuScenesCMRDataset(out, [path], mode="train", img_H=64, img_W=128, sample_point=512,
                              seed=0)
    ref = JaxCMR(jout, [jpath], mode="train", img_H=64, img_W=128, sample_point=512, seed=0)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        for key in ("rgb", "lidar", "init_intrinsic", "decalib_real_gt", "decalib_dual_gt"):
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
    s = NuScenesLargeRangeDataset(out, [path], mode="train", img_H=16, img_W=64,
                                  sample_point=1000, seed=0)[0]
    assert s["lidar"].shape == (1000, 3) and s["lidar_feats"].shape == (1000, 1)
