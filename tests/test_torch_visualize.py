"""The visual outputs of the port against the JAX package's, on the CPU:
``eval/visualize.py`` (every renderer bit for bit on the same inputs; the
PNG writer decoded by PIL equal to the array), ``Evaluator(vis_rate=...)``
and ``evaluate_torch.py --vis_rate`` against JAX's ``Evaluator`` with a
recording writer (the same tags and steps; the init and gt panels equal;
the pred panel equal to JAX's ``render_projection`` of the port's own out3,
since out3 differs from JAX's by f32 roundings that can cross a pixel
edge), the demo tools at ``--tiny``, and ``data/realloc.py``'s frames
against JAX's."""

import dataclasses
import functools
import importlib.util
import os
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

import evaluate_torch
from i2pnet_tpu import metrics as JM
from i2pnet_tpu.config import I2PNetConfig as JaxConfig
from i2pnet_tpu.config import I2PNetProjConfig as JaxProjConfig
from i2pnet_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from i2pnet_tpu.eval import visualize as JV
from i2pnet_tpu.eval.evaluator import Evaluator as JaxEvaluator
from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu.models import I2PNetProj as JaxI2PNetProj
from i2pnet_tpu_torch import metrics as M
from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.data import BatchLoader
from i2pnet_tpu_torch.eval import Evaluator
from i2pnet_tpu_torch.eval import visualize as V
from i2pnet_tpu_torch.models import I2PNet, I2PNetProj
from i2pnet_tpu_torch.ops import conv_cuda, cv_cuda, fps_cuda, select_cuda
from i2pnet_tpu_torch.train.checkpoint import CheckpointManager
from i2pnet_tpu_torch.utils import monitor
from _torch_util import port, randomize_stats
from test_torch_cmr import write_cmr_tree
from test_torch_data import write_large_range_tree
from test_torch_eval import MemoryDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E = np.eye(3, 4, dtype=np.float32)
K = np.array([[60.0, 0, 64], [0, 60.0, 32], [0, 0, 1]], np.float32)


def _fixtures():
    """An image, 300 points (some behind the camera, some on pixel edges)
    and a second extrinsic."""
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 255, size=(64, 128, 3), dtype=np.uint8)
    pts = rng.uniform(-5, 5, size=(300, 3)).astype(np.float32)
    pts[:, 2] += 10
    pts[:20, 2] = -pts[:20, 2]  # behind the camera
    # 20 points whose projections land exactly on integer pixels
    uv = rng.integers(0, 60, size=(20, 2)).astype(np.float32)
    z = np.float32(6.0)
    pts[20:40] = np.stack([(uv[:, 0] - 64) * z / 60, (uv[:, 1] - 32) * z / 60,
                           np.full(20, z)], 1)
    E2 = E.copy()
    E2[:, :3] = np.array([[0.995, -0.0998, 0], [0.0998, 0.995, 0], [0, 0, 1]], np.float32)
    E2[:, 3] = [0.3, -0.2, 0.5]
    return rgb, pts, E2


def _mask(pts):
    return np.random.default_rng(5).random(len(pts)) < 0.5


RENDERERS = {
    "project_points_full": lambda m, rgb, pts, E2: m.project_points_full(pts, E2, K, (64, 128)),
    "project_points_to_image": lambda m, rgb, pts, E2: m.project_points_to_image(
        pts, E2, K, (64, 128)),
    "depth_colors": lambda m, rgb, pts, E2: m._depth_colors(pts[:, 2]),
    "render_projection_r0": lambda m, rgb, pts, E2: m.render_projection(rgb, pts, E2, K, 0),
    "render_projection_r1": lambda m, rgb, pts, E2: m.render_projection(rgb, pts, E2, K),
    "render_projection_r2": lambda m, rgb, pts, E2: m.render_projection(rgb, pts, E, K, 2),
    "render_projection_empty": lambda m, rgb, pts, E2: m.render_projection(rgb, pts[:20], E, K),
    "render_comparison": lambda m, rgb, pts, E2: m.render_comparison(rgb, pts, E, E2, E, K),
    "render_error_heat_zero": lambda m, rgb, pts, E2: m.render_error_heat(rgb, pts, E, E, K),
    "render_error_heat": lambda m, rgb, pts, E2: m.render_error_heat(rgb, pts, E2, E, K, 5.0),
    "render_mask_overlay": lambda m, rgb, pts, E2: m.render_mask_overlay(rgb, pts, _mask(pts),
                                                                        E2, K),
    "depth_image": lambda m, rgb, pts, E2: m.depth_image(pts, E2, K, (64, 128)),
}


def _equal(a, b) -> None:
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a == b
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(RENDERERS))
def test_renderer_equals_jax(name):
    rgb, pts, E2 = _fixtures()
    _equal(RENDERERS[name](V, rgb, pts, E2), RENDERERS[name](JV, rgb, pts, E2))


def test_save_ply_equals_jax(tmp_path):
    _, pts, _ = _fixtures()
    V.save_ply(str(tmp_path / "port.ply"), pts)
    JV.save_ply(str(tmp_path / "jax.ply"), pts)
    colors = np.random.default_rng(0).integers(0, 255, size=(300, 3))
    V.save_ply(str(tmp_path / "port_c.ply"), pts, colors)
    JV.save_ply(str(tmp_path / "jax_c.ply"), pts, colors)
    for a, b in (("port.ply", "jax.ply"), ("port_c.ply", "jax_c.ply")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def test_heat_and_mask_semantics():
    """JAX's own checks of the panels hold for the port's: zero error is
    green, a large shift has no green; a perfect mask scores 1."""
    rgb, pts, _ = _fixtures()
    img = V.render_error_heat(rgb, pts, E, E, K)
    g = img[np.any(img != rgb, axis=-1)]
    assert len(g) and (g[:, 1] > 200).all() and (g[:, 0] < 50).all()
    E3 = E.copy()
    E3[0, 3] += 8.0
    px = V.render_error_heat(rgb, pts, E3, E, K, max_err_px=5.0)
    px = px[np.any(px != rgb, axis=-1)]
    assert not ((px[:, 1] > 200) & (px[:, 0] < 50)).any()
    gt = V.project_points_full(pts, E, K, (64, 128))[2]
    assert V.render_mask_overlay(rgb, pts, gt, E, K)[1] == {"accuracy": 1.0, "precision": 1.0,
                                                           "recall": 1.0}


def _png_rows(path):
    """The raw scanlines of a PNG written with filter type 0 (the zlib
    stream inflated), checking each chunk's CRC."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        assert int.from_bytes(data[pos + 8 + length:pos + 12 + length], "big") == \
            zlib.crc32(kind + body)
        if kind == b"IDAT":
            idat += body
        pos += 12 + length
    return zlib.decompress(idat)


@pytest.mark.parametrize("shape", [(64, 128, 3), (17, 23, 3), (1, 1, 3), (5, 7)],
                         ids=["rgb", "odd", "one_pixel", "grey"])
def test_png_writer_decodes_to_the_array(shape, tmp_path):
    from PIL import Image

    img = np.random.default_rng(1).integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    V.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    rows = np.frombuffer(_png_rows(path), np.uint8).reshape(shape[0], -1)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(shape), img)


def test_save_image_without_pil_gives_pils_pixels(tmp_path, monkeypatch):
    from PIL import Image

    rgb, pts, E2 = _fixtures()
    panel = V.render_comparison(rgb, pts, E, E2, E, K)
    V.save_image(str(tmp_path / "port.png"), panel)
    JV.save_image(str(tmp_path / "jax.png"), panel)
    monkeypatch.setitem(sys.modules, "PIL", None)
    V.save_image(str(tmp_path / "nopil.png"), panel)
    monkeypatch.delitem(sys.modules, "PIL")
    assert _png_rows(str(tmp_path / "port.png")) == _png_rows(str(tmp_path / "nopil.png"))
    for name in ("port.png", "jax.png", "nopil.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(str(tmp_path / name))), panel)
    with pytest.raises(ValueError, match="uint8"):
        V.write_png(str(tmp_path / "f.png"), panel.astype(np.float32))


def test_write_video(tmp_path, monkeypatch):
    """gif and mp4 as JAX writes them (imageio, else PIL's GIF); neither
    installed raises an ImportError naming both."""
    rgb, _, _ = _fixtures()
    frames = [rgb, 255 - rgb, rgb]
    for name in ("demo.gif", "demo.mp4"):
        got = V.write_video(str(tmp_path / name), frames, fps=5)
        want = JV.write_video(str(tmp_path / ("jax_" + name)), frames, fps=5)
        assert os.path.basename(got) == os.path.basename(want).replace("jax_", "")
        assert os.path.getsize(got) > 0
    with pytest.raises(ValueError, match="no frames"):
        V.write_video(str(tmp_path / "x.gif"), [])
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="imageio.*PIL"):
        V.write_video(str(tmp_path / "y.gif"), frames)


class RecordingWriter:
    """Keeps every image call: (method, tag, step, array)."""

    def __init__(self, *a, **k):
        self.calls, self.closed = [], False

    def add_image(self, tag, img, step):
        self.calls.append(("add_image", tag, step, np.array(img)))

    def add_images(self, tag, imgs, step):
        self.calls.append(("add_images", tag, step, np.array(imgs)))

    def close(self):
        self.closed = True


def _decalib_E(q, t):
    R = JM.quat_to_rotmat_batch(np.asarray(q)[None])[0]
    return np.concatenate([R, np.asarray(t).reshape(3, 1)], axis=1).astype(np.float32)


FAMILIES = {
    "free": (JaxConfig.tiny(), JaxI2PNet, I2PNetConfig, I2PNet, False),
    "proj": (JaxProjConfig.tiny(), JaxI2PNetProj, I2PNetProjConfig, I2PNetProj, True),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_evaluator_vis_rate_matches_jax(family, tmp_path, monkeypatch):
    jcfg, JaxModel, Cfg, Model, proj = FAMILIES[family]
    ds = MemoryDataset(5, 512, zero_tail=proj)
    s = ds[0]
    args = [s["rgb"][None], s["lidar"][None]] + ([s["raw_point_xyz"][None]] if proj else []) \
        + [s["init_intrinsic"][None]]
    jmodel = JaxModel(jcfg)
    v = randomize_stats(jax.jit(functools.partial(jmodel.init, train=False))(
        jax.random.key(0), *args), np.random.default_rng(2))
    models = [port(Model(Cfg(**dataclasses.asdict(jcfg)), device="cpu"), v)]
    monkeypatch.setenv("I2PNET_PROJ_DENSE_EVAL", "interpret")
    plog = []
    real = M.get_extrinsic
    monkeypatch.setattr(M, "get_extrinsic", lambda out3, *a, **k: (plog.append(np.array(out3)),
                                                                  real(out3, *a, **k))[1])
    jw, pw = RecordingWriter(), RecordingWriter()
    JaxEvaluator(jmodel, jcfg, [v["params"]], [v.get("batch_stats", {})], proj=proj,
                 log_dir=str(tmp_path / "jax"), writer=jw, vis_rate=2).validate(
        JaxBatchLoader(ds, 2, shuffle=False, drop_last=False))
    counts = (fps_cuda.launches, conv_cuda.launches, cv_cuda.launches, select_cuda.launches)
    ev = Evaluator(models, models[0].cfg, proj=proj, log_dir=str(tmp_path / "port"), writer=pw,
                   vis_rate=2, device="cpu")
    ev.validate(BatchLoader(ds, 2, shuffle=False, drop_last=False))
    assert (fps_cuda.launches, conv_cuda.launches, cv_cuda.launches,
            select_cuda.launches) == counts  # CPU: the plain versions

    tags = ["init_projected_img", "pj_projected_img", "gt_projected_img"]
    want = [(m, t, step) for step in (0, 1) for m, t in
            [("add_image", t) for t in tags] + [("add_images", "comparison_img")]]
    assert [c[:3] for c in pw.calls] == [c[:3] for c in jw.calls] == want
    for bi, step in ((0, 0), (2, 1)):  # sample 0 of batches 0 and 2
        port_calls = {c[1]: c[3] for c in pw.calls if c[2] == step}
        jax_calls = {c[1]: c[3] for c in jw.calls if c[2] == step}
        for tag in ("init_projected_img", "gt_projected_img"):
            np.testing.assert_array_equal(port_calls[tag], jax_calls[tag])
        s = ds[2 * bi]
        out3 = plog[bi][0]
        pred = JV.render_projection(np.clip(s["rgb"], 0, 255).astype(np.uint8), s["lidar"],
                                    _decalib_E(out3[:4], out3[4:]), s["init_intrinsic"])
        np.testing.assert_array_equal(port_calls["pj_projected_img"], pred)
        np.testing.assert_array_equal(port_calls["comparison_img"], np.stack(
            [port_calls[t] for t in tags]))
    assert pw.calls[0][3].dtype == np.uint8 and pw.calls[0][3].shape == (64, 128, 3)


def test_uniwriter_fans_images_out(tmp_path):
    """add_image / add_images reach TensorBoard's event file where
    tensorboardX is installed; without it they are no-ops, as in JAX."""
    w = monitor.UniWriter(str(tmp_path))
    img = np.zeros((4, 6, 3), np.uint8)
    w.add_image("a", img, 0)
    w.add_images("b", np.stack([img, img]), 0)
    w.close()
    if importlib.util.find_spec("tensorboardX") is not None:
        assert any(f.startswith("events") for f in os.listdir(str(tmp_path)))
    monitor.UniWriter(str(tmp_path / "no_tb"), enable_tb=False).add_images("b", img[None], 0)


def test_evaluate_torch_vis_rate(tmp_path, monkeypatch):
    """evaluate_torch.py --vis_rate 2 --device cpu: a writer on --log_dir gets
    the overlays of batches 0 and 2 and is closed."""
    root = write_large_range_tree(str(tmp_path / "data"), (7, 8), 3, 3000, seed=5)
    run = str(tmp_path / "run")
    CheckpointManager(run).save_best("model_rotation_best", {
        "model": I2PNetProj(I2PNetProjConfig.tiny(), device="cpu").state_dict()})
    writers = []
    monkeypatch.setattr(monitor, "UniWriter", lambda log_dir: writers.append(
        RecordingWriter()) or writers[-1])
    log_dir = str(tmp_path / "eval")
    summary = evaluate_torch.main(["--tiny", "--root_path", root, "--model_dir", run, "--device",
                                   "cpu", "--batch_size", "2", "--vis_rate", "2", "--log_dir",
                                   log_dir])
    assert summary["count"] == 6
    (w,) = writers
    assert w.closed and [c[2] for c in w.calls] == [0] * 4 + [1] * 4
    assert {c[1] for c in w.calls} == {"init_projected_img", "pj_projected_img",
                                       "gt_projected_img", "comparison_img"}


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("family", ["free", "proj"])
def test_render_demo_tool_at_tiny(family, tmp_path):
    """tools/render_demo_torch.py --tiny on the CPU: one PNG a frame (B=1
    forwards), each JAX's render_comparison (and, with --heat, its
    render_error_heat) of the port's own B=1 out3, a GIF of the frames."""
    from PIL import Image

    from i2pnet_tpu_torch.cli import build, eval_split

    proj = family == "proj"
    if proj:
        root = write_large_range_tree(str(tmp_path / "data"), (7, 8), 2, 3000, seed=5)
        argv = ["--dataset", "kd_corr_nolidar", "--network", "i2pnet_proj"]
    else:
        root = write_cmr_tree(str(tmp_path / "data"), {0: range(3)})
        argv = ["--dataset", "kd_cmr_snr", "--network", "i2pnet", "--heat"]
    run, out = str(tmp_path / "run"), str(tmp_path / "frames")
    argv += ["--root_path", root, "--model_dir", run, "--tiny", "--device", "cpu", "--out", out,
             "--frames", "3", "--video", str(tmp_path / "demo.gif")]
    tool = _load_tool("render_demo_torch")
    args = evaluate_torch.parse_args(["--model_dir", run, "--tiny", "--device", "cpu",
                                      "--network", argv[3], "--dataset", argv[1],
                                      "--root_path", root])
    model, cfg, _ = build(args)
    CheckpointManager(run).save_best("model_rotation_best", {"model": model.state_dict()})
    times = tool.main(argv)
    assert times["frames"] == 3 and len(times["forward_ms"]) == 3
    assert sorted(os.listdir(out)) == [f"frame_{i:06d}.png" for i in range(3)]
    assert os.path.getsize(str(tmp_path / "demo.gif")) > 0
    ds = eval_split(args, cfg)
    model.eval()
    for i in range(3):
        s = ds[i]
        x = {k: torch.from_numpy(np.asarray(s[k], np.float32))[None]
             for k in ("rgb", "lidar", "raw_point_xyz", "init_intrinsic", "lidar_feats")}
        with torch.no_grad():
            o = (model(x["rgb"], x["lidar"], x["raw_point_xyz"], x["init_intrinsic"],
                       lidar_feature=x["lidar_feats"]) if proj else
                 model(x["rgb"], x["lidar"], x["init_intrinsic"], lidar_feature=x["lidar_feats"],
                       raw_xyz=x["raw_point_xyz"]))["out3"][0].numpy()
        rgb = np.clip(s["rgb"], 0, 255).astype(np.uint8)
        pred_E = _decalib_E(o[:4], o[4:])
        gt_E = _decalib_E(s["decalib_real_gt"], s["decalib_dual_gt"])
        want = JV.render_comparison(rgb, s["lidar"], E, pred_E, gt_E, s["init_intrinsic"])
        if not proj:
            want = np.concatenate([want, JV.render_error_heat(rgb, s["lidar"], pred_E, gt_E,
                                                              s["init_intrinsic"])], axis=0)
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(
            out, f"frame_{i:06d}.png"))), want)


def _real_tree(root):
    from PIL import Image

    rng = np.random.default_rng(0)
    for seq, ts in [("00", "1690000000.1"), ("00", "1690000001.2"), ("01", "1690000002.3")]:
        vdir = os.path.join(root, "sequences", seq, "velodyne")
        idir = os.path.join(root, "sequences", seq, "images")
        os.makedirs(vdir, exist_ok=True)
        os.makedirs(idir, exist_ok=True)
        pts = rng.uniform(-10, 10, size=(200, 4)).astype(np.float32)
        pts[:, 2] += 15.0
        pts.tofile(os.path.join(vdir, f"{ts}.bin"))
        img = Image.fromarray(rng.integers(0, 255, size=(64, 96, 3), dtype=np.uint8))
        img.save(os.path.join(idir, f"{ts}.jpg" if seq == "00" else f"{ts}.png"))
    E1 = np.hstack([np.eye(3), np.array([[0.1], [0.0], [0.5]])])
    row = " ".join(f"{v:.6f}" for v in E1.ravel())
    pred = os.path.join(root, "prediction.txt")
    with open(pred, "w") as f:
        f.write("\n".join([f"§ {i}\n" + "\n".join(f"{k} {row}" for k in ("init", "pred", "gt"))
                           for i in range(3)]) + "\n")
    return pred


def test_realloc_dataset_matches_jax(tmp_path):
    from i2pnet_tpu.data.realloc import REALLOC_K as JK
    from i2pnet_tpu.data.realloc import RealLocVisDataset as JaxRealLoc
    from i2pnet_tpu_torch.data.params import REAL_DATA
    from i2pnet_tpu_torch.data.realloc import REALLOC_K, RealLocVisDataset

    root = str(tmp_path / "real_localize")
    _real_tree(root)
    assert REAL_DATA["test"]["root_path"].endswith("real_localize")
    np.testing.assert_array_equal(REALLOC_K, JK)
    ours, ref = RealLocVisDataset(root), JaxRealLoc(root)
    assert ours.frames == ref.frames and len(ours) == 3
    for i in range(3):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys() and (a["seq"], a["ts"]) == (b["seq"], b["ts"])
        for key in ("img", "pcl", "intensity", "K"):
            _equal(a[key], b[key])
    sub = RealLocVisDataset(root, frames=[("01", "1690000002.3")])
    assert len(sub) == 1 and sub[0]["img"].shape == (64, 96, 3)
    with pytest.raises(FileNotFoundError):
        RealLocVisDataset(root, frames=[("00", "missing")])[0]


def test_real_demo_matches_jax(tmp_path, monkeypatch):
    """tools/render_real_demo_torch.py against tools/render_real_demo.py: the
    same PNG names and pixels, and a GIF; again without PIL (the port's
    PNG writer)."""
    from PIL import Image

    root = str(tmp_path / "real_localize")
    pred = _real_tree(root)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from render_real_demo import render_real_demo as jax_demo

    ours = _load_tool("render_real_demo_torch")
    assert ours.main(["--root", root, "--pred", pred, "--out", str(tmp_path / "port"),
                      "--video", "demo.gif"]) == 3
    assert jax_demo(root, pred, str(tmp_path / "jax")) == 3
    names = sorted(f for f in os.listdir(str(tmp_path / "jax")) if f.endswith(".png"))
    assert sorted(f for f in os.listdir(str(tmp_path / "port")) if f.endswith(".png")) == names
    assert os.path.exists(str(tmp_path / "port" / "demo.gif"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert ours.render_real_demo(root, pred, str(tmp_path / "nopil"), max_frames=2) == 2
    monkeypatch.delitem(sys.modules, "PIL")
    for name in names:
        want = np.asarray(Image.open(str(tmp_path / "jax" / name)))
        np.testing.assert_array_equal(np.asarray(Image.open(str(tmp_path / "port" / name))), want)
        if name in os.listdir(str(tmp_path / "nopil")):
            np.testing.assert_array_equal(
                np.asarray(Image.open(str(tmp_path / "nopil" / name))), want)
