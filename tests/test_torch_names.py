"""Every public name of the JAX package has a counterpart in the port: a
function, class or constant of the same name in the module at the same
path under ``i2pnet_tpu_torch/`` (a Pallas kernel's module maps to its
CUDA wrapper's, ``MODULES``), or an entry of ``OTHERS``, which names the
port's counterpart elsewhere or why there is none (ROADMAP.md, "Unported
by design"). Read from the sources with ``ast``; nothing is imported."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = os.path.join(ROOT, "i2pnet_tpu"), os.path.join(ROOT, "i2pnet_tpu_torch")

MODULES = {"ops/conv_pallas.py": "ops/conv_cuda.py", "ops/conv_pallas_train.py":
           "ops/conv_train_cuda.py", "ops/cv_pallas.py": "ops/cv_cuda.py",
           "ops/fps_pallas.py": "ops/fps_cuda.py", "ops/select_pallas.py": "ops/select_cuda.py"}

# (JAX module, name): (port module, name) of its counterpart, or the reason
# there is none
OTHERS = {
    ("nn/layers.py", "batch_norm"): ("nn/layers.py", "BatchNorm"),
    ("nn/proj_backbone.py", "proj_dense_eval_mode"): ("nn/layers.py", "eval_route"),
    ("ops/conv_pallas.py", "fused_encoder_stage"): ("nn/layers.py", "RGBEncoderStage"),
    ("ops/conv_pallas.py", "pack_block_weights"):
        "the TPU's 128-lane phase packing; the kernel takes HWIO weights",
    ("ops/conv_pallas_train.py", "conv_phase"): ("ops/conv_train_cuda.py", "conv_fwd"),
    ("ops/conv_pallas_train.py", "conv_phase_dw"): ("ops/conv_train_cuda.py", "conv_dw"),
    ("ops/conv_pallas_train.py", "flip_transpose_kernel"): ("ops/conv_train_cuda.py", "conv_dx"),
    ("ops/conv_pallas_train.py", "unpack_dw"):
        "the adjoint of the TPU's phase packing; the kernel writes (cout, cin, 3, 3)",
    ("ops/fps_pallas.py", "fps_pallas"): ("ops/fps_cuda.py", "fps_cuda"),
    ("ops/select_pallas.py", "selection_multiplicity_pallas"):
        ("ops/select_cuda.py", "selection_multiplicity_cuda"),
    ("ops/pointops.py", "KNN_RECALL_TARGET"):
        "approx_min_k's recall on the TPU; the port's KNN is always exact",
    ("ops/scatter.py", "scatter_add_rows"): "a TPU segment sum; the port indexes",
    ("ops/scatter.py", "take_rows"): ("ops/projection.py", "gather_grid"),
    ("parallel/distributed.py", "make_global_batch"):
        ("parallel/distributed.py", "host_batch_slice"),
    ("parallel/mesh.py", "batch_spec"): ("parallel/distributed.py", "host_batch_rows"),
    ("parallel/mesh.py", "replicate_spec"): ("parallel/mesh.py", "replicate_"),
    ("parallel/mesh.py", "shard_batch"): ("parallel/mesh.py", "fan_out_rows"),
    ("parallel/mesh.py", "make_mesh_2d"): "the (data, space) mesh, XLA's partitioner",
    ("parallel/mesh.py", "shard_batch_spatial"): "the (data, space) mesh, XLA's partitioner",
    ("parallel/mesh.py", "shard_train_step_spatial"): "the (data, space) mesh",
    ("parallel/mesh.py", "spatial_batch_specs"): "the (data, space) mesh",
    ("utils/platform.py", "honor_jax_platforms_env"): "JAX's platform selection",
}


def _names(path, public=False):
    """Top-level definitions, assignments and imports of a source file."""
    out = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and not public:
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")} if public else out


def _jax_modules():
    for dirpath, _, files in os.walk(JAX):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), JAX)


@pytest.mark.parametrize("module", sorted(_jax_modules()))
def test_every_public_name_has_a_counterpart(module):
    port = os.path.join(PORT, MODULES.get(module, module))
    here = _names(port) if os.path.exists(port) else set()
    missing = [n for n in sorted(_names(os.path.join(JAX, module), public=True))
               if n not in here and (module, n) not in OTHERS]
    assert not missing, f"{module}: no counterpart in the port for {missing}"


def test_others_are_current():
    """Each entry names a public name of the JAX package without a
    same-named counterpart, and each counterpart exists."""
    for (module, name), other in OTHERS.items():
        assert name in _names(os.path.join(JAX, module), public=True), (module, name)
        port = os.path.join(PORT, MODULES.get(module, module))
        assert not os.path.exists(port) or name not in _names(port), (module, name)
        if isinstance(other, tuple):
            assert other[1] in _names(os.path.join(PORT, other[0])), other
