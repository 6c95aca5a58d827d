"""What a run imports, and a run without a card: after a rehearsal of a
cell on the CPU has gone as far as it can without the card, no module of
JAX or of the JAX package is loaded (top-level names compared whole; the
port's name begins with the JAX package's); ``run.py`` exits 2 with no
result line where there is no card, and non-zero where the program is not
beside the benchmark."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import textwrap


from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "i2pnet_tpu"}


def test_a_rehearsal_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {ROOT!r})
        from h100_bench import harness
        cell = harness.load_cell("tiny-free-eval", {tiny_root!r})
        res = harness.run_cell(cell, 5, 0.5, True, "cpu", time.perf_counter())
        assert res["correct"], res["checks"]
        loaded = sorted({{m.split(".")[0] for m in sys.modules}})
        assert "i2pnet_tpu_torch" in loaded
        print(" ".join(loaded))
        print("FOUND", harness.forbidden_modules())
    """)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(out.stdout.splitlines()[-2].split())
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert out.stdout.splitlines()[-1] == "FOUND []"


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "tiny-free-eval",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0", *extra],
                          capture_output=True, text=True, timeout=300, cwd=cwd,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_exits_2_without_a_card(tiny_root):
    out = _run(tiny_root)
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_run_fails_with_only_the_benchmark_beside_it(tiny_root, tmp_path):
    shutil.copytree(os.path.join(tiny_root, "h100_bench"), tmp_path / "h100_bench")
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_harness_finds_forbidden_names_whole():
    from h100_bench import harness

    sys.modules["i2pnet_tpu_like_name_test"] = sys.modules["os"]
    try:
        assert "i2pnet_tpu" not in harness.forbidden_modules()
        sys.modules["i2pnet_tpu"] = sys.modules["os"]
        assert "i2pnet_tpu" in harness.forbidden_modules()
    finally:
        sys.modules.pop("i2pnet_tpu_like_name_test", None)
        sys.modules.pop("i2pnet_tpu", None)
