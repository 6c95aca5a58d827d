"""The port imports torch and never jax, nor any module of the JAX package
(``i2pnet_tpu``), not even one that imports no jax; nor do its scripts
(``chip_smoke.py``, ``evaluate_torch.py``, ``train_torch.py``,
``tools/synthetic_convergence_torch.py`` and the reference-checkpoint and
demo tools), with every import each makes
anywhere in the file. Importing all of it loads neither h5py nor PIL (the
loaders import them when a sample is read) nor pandas.

Run in a subprocess: this test process already holds jax (conftest.py)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the projection family's modules and the pool backwards' (the route
# kernel's wrapper; the train step and encoder modules that select them),
# loaded with the rest of the package
NEW = [
    "i2pnet_tpu_torch.ops.projection",
    "i2pnet_tpu_torch.ops.dense_window",
    "i2pnet_tpu_torch.ops.select_cuda",
    "i2pnet_tpu_torch.nn.proj_backbone",
    "i2pnet_tpu_torch.models.i2pnet_proj",
    "i2pnet_tpu_torch.ops.pool_route_cuda",
    "i2pnet_tpu_torch.ops.conv_train_cuda",
    "i2pnet_tpu_torch.nn.layers",
    "i2pnet_tpu_torch.train.step",
    # the evaluation harness: se3 and the metrics, the data layer (the
    # large-range loader and its transforms, native IO and the pipeline),
    # the checkpoints, the evaluator and analysis, seeding, cli.build
    "i2pnet_tpu_torch.ops.se3",
    "i2pnet_tpu_torch.metrics",
    "i2pnet_tpu_torch.data",
    "i2pnet_tpu_torch.data.calib",
    "i2pnet_tpu_torch.data.transforms",
    "i2pnet_tpu_torch.data.native_io",
    "i2pnet_tpu_torch.data.kitti_large_range",
    "i2pnet_tpu_torch.data.pipeline",
    "i2pnet_tpu_torch.train.checkpoint",
    "i2pnet_tpu_torch.eval",
    "i2pnet_tpu_torch.eval.evaluator",
    "i2pnet_tpu_torch.eval.analysis",
    "i2pnet_tpu_torch.utils",
    "i2pnet_tpu_torch.utils.seeding",
    "i2pnet_tpu_torch.cli",
    # the training entry point: the trainer and its utilities
    "i2pnet_tpu_torch.train.trainer",
    "i2pnet_tpu_torch.utils.avgmeter",
    "i2pnet_tpu_torch.utils.monitor",
    "i2pnet_tpu_torch.utils.timings",
    # the vehicle-localisation protocols: the test tables, the KITTI
    # odometry small-range and the nuScenes loaders
    "i2pnet_tpu_torch.data.preprocess",
    "i2pnet_tpu_torch.data.kitti_odometry_cmr",
    "i2pnet_tpu_torch.data.nuscenes",
    # what a user runs around the model: the visual outputs, the real-rig
    # frames and the offline dataset builders
    "i2pnet_tpu_torch.eval.visualize",
    "i2pnet_tpu_torch.data.realloc",
    "i2pnet_tpu_torch.data.nuscenes_lite",
    "i2pnet_tpu_torch.data.preprocess_nuscenes",
    # data parallelism on torch.distributed
    "i2pnet_tpu_torch.parallel",
    "i2pnet_tpu_torch.parallel.distributed",
    "i2pnet_tpu_torch.parallel.mesh",
    # the eval kernels as torch.library ops (the serving export)
    "i2pnet_tpu_torch.ops.library",
    # the last of the JAX package's code: the ResNet encoder (exported by
    # nn/__init__), the generic window select and grid helpers, dist_mode,
    # the exact k-smallest indices and worker seeds
    "i2pnet_tpu_torch.nn",
    "i2pnet_tpu_torch.nn.resnet",
    "i2pnet_tpu_torch.ops.pointops",
    # the spans
    "i2pnet_tpu_torch.utils.trace",
]
SCRIPTS = ["chip_smoke.py", "evaluate_torch.py", "train_torch.py",
           "tools/synthetic_convergence_torch.py", "tools/reference_ckpt_to_torch.py",
           "tools/render_demo_torch.py", "tools/render_real_demo_torch.py",
           "tools/export_model_torch.py"]

PROBE = f"NEW = {NEW!r}\nSCRIPTS = {SCRIPTS!r}\n" + """
import ast, importlib, importlib.util, os, pkgutil, sys
import i2pnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(i2pnet_tpu_torch.__path__, "i2pnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for script in SCRIPTS:
    for node in ast.walk(ast.parse(open(script).read())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                importlib.import_module(alias.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            importlib.import_module(node.module)
    name = os.path.basename(script)[:-3]
    spec = importlib.util.spec_from_file_location(name, script)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(len(names))
for name in NEW:
    assert name in names, name
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
jax_package = sorted(m for m in sys.modules if m.split(".")[0] == "i2pnet_tpu")
assert not jax_package, jax_package
assert "torch" in sys.modules
# the loaders import h5py and PIL only when a sample is read; nothing imports pandas
readers = sorted(m for m in ("h5py", "PIL", "pandas") if m in sys.modules)
assert not readers, readers
"""


def test_port_imports_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    # the walk found the whole package (62 modules and subpackages)
    assert int(proc.stdout.split()[-1]) == 62
