"""The serving export of the PyTorch port (``tools/export_model_torch.py``)
and the eval kernels' ``torch.library`` ops (``ops/library.py``), on the
CPU.

- ``torch.library.opcheck`` on each of the four ops (schema, fake
  implementation against the real one, shapes, dtypes and strides);
- the exported program equals the eager forward bit for bit, for the
  tiny free and proj configs in f32 (saved and loaded back) and in bf16 (the bf16
  free config with tests/test_torch_model.py's depth-3 cv1 ``mlp1``, which
  the fused cv1 gate takes). The gates decide outside the ops, so in bf16
  the program holds one ``i2pnet::*`` node a kernel call: FPS and select
  in either dtype, the encoder block and cv1 in bf16;
- the port's f32 export against JAX's ``export_model`` (weights carried
  across by ``convert.load_flax_variables``), both programs run on the same
  inputs, within tests/test_torch_model.py's and
  tests/test_torch_proj_model.py's 2e-4;
- a program refuses inputs of another shape (the twin of
  tests/test_export.py's ``test_export_rejects_wrong_shape``), and loads in
  a process that imports only torch and the op library;
- on the card (skipped without one): the exported bf16 programs equal the
  eager forwards bit for bit, and launch the kernels the eager forwards do.

This file imports jax only inside the tests that need it, so on the card's
machine it runs as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_export.py -k cuda``.
"""

import dataclasses
import io
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_flax_
from i2pnet_tpu_torch.ops import conv_cuda, cv_cuda, dense_level_cuda, fps_cuda, select_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import export_model_torch as X  # noqa: E402

IMG_HW = (64, 128)
B = 2
CONFIGS = {
    ("free", "f32"): I2PNetConfig.tiny(),
    ("free", "bf16"): dataclasses.replace(
        I2PNetConfig.tiny(), cost_volume_mlps=((16, 16, 16), (16, 16)),
        compute_dtype="bfloat16"),
    ("proj", "f32"): I2PNetProjConfig.tiny(),
    ("proj", "bf16"): dataclasses.replace(I2PNetProjConfig.tiny(), compute_dtype="bfloat16"),
}
# i2pnet::* nodes of each tiny program: FPS at 4 levels, select at 5, the
# encoder block at 2 stages of 3 blocks, cv1 once
NODES = {
    ("free", "f32"): {"fps": 4},
    ("free", "bf16"): {"fps": 4, "conv_block": 6, "cv1": 1},
    ("proj", "f32"): {"select_multiplicity": 5},
    ("proj", "bf16"): {"select_multiplicity": 5, "conv_block": 6},
}


def _model(family, cfg, device="cpu", variables=None):
    """The family's port model in eval mode: JAX's variables where given,
    else fresh weights from seed 0."""
    Model = I2PNetProj if family == "proj" else I2PNet
    model = Model(cfg, device=device)
    if variables is None:
        init_flax_(model, torch.Generator().manual_seed(0))
    else:
        from i2pnet_tpu_torch.convert import load_flax_variables

        load_flax_variables(model, variables)
    return model.eval()


def _inputs(family, cfg, device="cpu"):
    """Inputs at the export's shapes. Free: the tool's example inputs. Proj:
    the tool's draw zeroes every point of a 4096-point cloud (its zero tail
    is 30000 points long), so the programs are run on a cloud of 2048 real
    points and a zero tail, decalibrated."""
    if family == "free":
        return X.example_inputs(cfg, False, B, IMG_HW, device=device)
    from i2pnet_tpu_torch.ops import quaternion as Q

    rng = np.random.default_rng(7)
    rgb, _, _, k = X.example_inputs(cfg, True, B, IMG_HW, device=device)
    raw = (rng.normal(size=(B, 4096, 3)) * 10).astype(np.float32)
    raw[:, 2048:] = 0.0
    raw = torch.from_numpy(raw).to(device)
    q = torch.tensor([[np.cos(0.1), 0.0, np.sin(0.1), 0.0]] * B, dtype=torch.float32,
                     device=device)
    t = torch.tensor([[0.5, 0.0, 0.3]] * B, dtype=torch.float32, device=device)
    lidar = Q.warp_points(raw, q, t) * (torch.sum(raw**2, -1, keepdim=True) > 0)
    return rgb, lidar, raw, k


def _nodes(program) -> Counter:
    return Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("i2pnet."))


@pytest.fixture(scope="module")
def exported():
    """{(family, dtype): (model, serialized program or None, the program's
    module, flax variables or None)} for the four tiny configs, on the CPU.
    The f32 models carry the JAX model's initial variables (statistics
    randomised), and their programs go through ``torch.export.save`` and
    ``load_exported``; the bf16 programs are run as traced (a save and a
    load take ~10 s a program here)."""
    out = {}
    for (family, dtype), cfg in CONFIGS.items():
        variables = _jax_variables(family) if dtype == "f32" else None
        model = _model(family, cfg, variables=variables)
        program = X.export_program(model, cfg, family == "proj", B, IMG_HW)
        assert _nodes(program) == NODES[family, dtype], (family, dtype, _nodes(program))
        if dtype == "f32":
            buf = io.BytesIO()
            torch.export.save(program, buf)
            out[family, dtype] = (model, buf.getvalue(), X.load_exported(buf.getvalue()),
                                  variables)
        else:
            out[family, dtype] = (model, None, program.module(), None)
    return out


def _jax_model(family):
    """The JAX package's tiny model of the family and its config."""
    from i2pnet_tpu.config import I2PNetConfig as JCfg, I2PNetProjConfig as JProjCfg
    from i2pnet_tpu.models import I2PNet as JI2PNet, I2PNetProj as JI2PNetProj

    if family == "proj":
        return JI2PNetProj(JProjCfg.tiny()), JProjCfg.tiny()
    return JI2PNet(JCfg.tiny()), JCfg.tiny()


def _jax_variables(family):
    import jax

    import export_model as JX
    from _torch_util import randomize_stats

    jm, jcfg = _jax_model(family)
    ex = JX.example_inputs(jcfg, family == "proj", B, IMG_HW)
    v = jax.jit(jm.init, static_argnames="train")(jax.random.key(0), *ex, train=False)
    return randomize_stats(v, np.random.default_rng(1))


def _counts():
    return (fps_cuda.launches, conv_cuda.launches, cv_cuda.launches, select_cuda.launches,
            dense_level_cuda.launches)


def test_ops_pass_opcheck():
    g = torch.Generator().manual_seed(0)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    torch.library.opcheck(torch.ops.i2pnet.fps.default, (rn(2, 40, 3), 8))
    for stride in (1, 2):
        torch.library.opcheck(torch.ops.i2pnet.conv_block.default,
                              (rn(2, 9, 12, 5), rn(3, 3, 5, 16), rn(16).abs() + 0.5, rn(16),
                               stride))
    torch.library.opcheck(torch.ops.i2pnet.select_multiplicity.default,
                          (rn(2, 8, 16, 3), 4, 8, [2, 2], [3, 5], 4, 1.5))
    Bc, N, K, C, H1, H2, H3, E, G1 = 2, 8, 20, 16, 16, 16, 16, 16, 16
    bf = torch.bfloat16
    operands = (rn(Bc, N, C, dtype=bf), rn(Bc, N, H1), rn(Bc, N, E), rn(Bc, K, C, dtype=bf),
                rn(Bc, K, H1), rn(Bc, K, E), rn(C, H1, dtype=bf), rn(H1, H2, dtype=bf), rn(H2),
                rn(H2, H3, dtype=bf), rn(H3), rn(E, G1, dtype=bf), rn(H3, G1, dtype=bf), rn(G1),
                rn(G1, H3, dtype=bf), rn(H3))
    torch.library.opcheck(torch.ops.i2pnet.cv1.default, operands)


@pytest.mark.parametrize("key", sorted(CONFIGS), ids=lambda k: "-".join(k))
def test_exported_program_equals_eager(exported, key):
    family, _ = key
    model, _, fn, _ = exported[key]
    args = _inputs(family, CONFIGS[key])
    before = _counts()
    with torch.no_grad():
        out3 = model(*args)["out3"]
        got = fn(*args)
    assert _counts() == before  # the CPU runs the plain versions
    assert torch.isfinite(out3).all() and float(out3.abs().max()) > 0
    assert torch.equal(got["q"], out3[:, :4]) and torch.equal(got["t"], out3[:, 4:])


@pytest.mark.parametrize("family", ["free", "proj"])
def test_export_matches_jax_export(exported, family):
    import jax

    import export_model as JX

    _, _, fn, v = exported[family, "f32"]
    jm, jcfg = _jax_model(family)
    jfn = JX.load_exported(JX.export_model(jm, v, jcfg, family == "proj", B, img_hw=IMG_HW))
    args = _inputs(family, CONFIGS[family, "f32"])
    with torch.no_grad():
        got = fn(*args)
    ref = jax.jit(jfn)(*(a.numpy() for a in args))
    for k in ("q", "t"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=2e-4, atol=2e-4)


def test_export_rejects_wrong_shape(exported, tmp_path):
    """A program refuses an image of another height; a process that imports
    only torch and the op library loads it and reproduces the outputs."""
    model, blob, fn, _ = exported["free", "f32"]
    args = _inputs("free", CONFIGS["free", "f32"])
    bad = (args[0][:, :32],) + args[1:]
    with pytest.raises(Exception):
        fn(*bad)

    path = tmp_path / "free.pt2"
    path.write_bytes(blob)
    torch.save(args, tmp_path / "args.pt")
    code = (
        "import sys, torch\n"
        "import i2pnet_tpu_torch.ops.library\n"
        f"fn = torch.export.load({str(path)!r}).module()\n"
        f"args = torch.load({str(tmp_path / 'args.pt')!r})\n"
        "with torch.no_grad():\n"
        "    out = fn(*args)\n"
        f"torch.save(out, {str(tmp_path / 'out.pt')!r})\n"
        "mods = [m for m in sys.modules if m.startswith(('i2pnet_tpu_torch.models', "
        "'i2pnet_tpu_torch.nn', 'jax', 'i2pnet_tpu.'))]\n"
        "assert not mods, mods\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
    out = torch.load(tmp_path / "out.pt")
    with torch.no_grad():
        out3 = model(*args)["out3"]
    assert torch.equal(out["q"], out3[:, :4]) and torch.equal(out["t"], out3[:, 4:])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["free", "proj"])
def test_exported_program_equals_eager_on_the_card(family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CONFIGS[family, "bf16"]
    model = _model(family, cfg, device="cuda")
    blob = X.export_model(model, cfg, family == "proj", B, IMG_HW)
    args = _inputs(family, cfg, device="cuda")
    fn = X.load_exported(blob)
    with torch.no_grad():
        c0 = _counts()
        out3 = model(*args)["out3"]
        c1 = _counts()
        got = fn(*args)
        torch.cuda.synchronize()
        c2 = _counts()
    eager = [b - a for a, b in zip(c0, c1)]
    assert eager == [b - a for a, b in zip(c1, c2)] and sum(eager) > 0
    assert torch.equal(got["q"], out3[:, :4]) and torch.equal(got["t"], out3[:, 4:])
