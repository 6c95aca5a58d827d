"""The yardstick's work counts at known shapes, worked by hand."""

from __future__ import annotations

import importlib
import importlib.util
import os

import pytest
import torch

from h100_bench import harness, work


def _kernel(name):
    path = os.path.join(harness.BENCH, "kernels", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"k_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_cv1_at_the_bench_shape_is_0_105_tflop():
    # B=8 points N=256 against K=480 pixels (384x1280 / 32), C=128, D=64:
    # per (point, pixel) 128*128 + 128*64 + 64*64 (mlp1 after the
    # correlation) + 64*128 + 64*128 + 128*64 (mlp2) = 53248 multiply-adds
    bf = torch.bfloat16
    a = (meta(8, 256, 128, dtype=bf), meta(8, 256, 128), meta(8, 256, 64),
         meta(8, 480, 128, dtype=bf), meta(8, 480, 128), meta(8, 480, 64),
         meta(128, 128, dtype=bf), meta(128, 64, dtype=bf), meta(64), meta(64, 64, dtype=bf),
         meta(64), meta(64, 128, dtype=bf), meta(64, 128, dtype=bf), meta(128),
         meta(128, 64, dtype=bf), meta(64))
    assert work.cv1_flops(a) == 2 * 8 * 256 * 480 * 53248
    assert work.cv1_flops(a) == pytest.approx(0.1047e12, rel=1e-3)
    # operations bound it: 0.1059 ms at 989 TFLOP/s
    assert _kernel("cv1").bound(a, meta(8, 256, 64)) == pytest.approx(0.10587e-3, rel=1e-3)


def test_fps_bound_of_the_free_pyramid_is_22_9_us():
    # 10 f32 operations per point and step: 8 x (2048 x 8192 + 1024 x 2048
    # + 256 x 1024 + 64 x 256) steps x points at 67 TFLOP/s
    k = _kernel("fps")
    calls = [(8192, 2048), (2048, 1024), (1024, 256), (256, 64)]
    total = sum(k.bound((meta(8, n, 3), s), meta(8, s, dtype=torch.int64)) for n, s in calls)
    assert total == pytest.approx(10 * 8 * (2048 * 8192 + 1024 * 2048 + 256 * 1024 + 64 * 256)
                                  / 67e12, rel=1e-9)
    assert total == pytest.approx(22.87e-6, rel=1e-3)


def test_first_encoder_block_is_bound_by_its_bytes():
    # x (8, 384, 1280, 3) bf16 in, (8, 192, 640, 16) bf16 out after the
    # stride-2 pool: 23.6 + 31.5 MB at 3.35 TB/s = 16.4 us, above its
    # 3.40 GFLOP at 989 TFLOP/s = 3.4 us
    bf = torch.bfloat16
    x, w, out = meta(8, 384, 1280, 3, dtype=bf), meta(3, 3, 3, 16, dtype=bf), meta(
        8, 192, 640, 16, dtype=bf)
    flops = work.conv_flops(x, 3, 16)
    assert flops == 2 * 8 * 384 * 1280 * 9 * 3 * 16
    byte_count = (8 * 384 * 1280 * 3 + 27 * 16 + 8 * 192 * 640 * 16) * 2 + 2 * 16 * 4
    b = _kernel("encoder_block").bound((x, w, meta(16), meta(16), 2), out)
    assert b == pytest.approx(byte_count / 3.35e12, rel=1e-12)
    assert b > flops / 989e12


def test_select_counts_the_queries_that_select():
    # m (B=1, 2 queries, 135 + 1 slots): one query with hits, one without
    m = torch.zeros(1, 2, 136)
    m[0, 0, 3] = 32
    m[0, 1, 135] = 32
    fn = _kernel("select").bound((torch.zeros(1, 4, 8, 3), 2, 1, (4, 8), (9, 15), 32, 0.75), m)
    ops = 13.0 * 2 * 135 + 2.0 * 135 * 1
    bytes_ = 4 * 8 * 3 * 4 + 2 * 136 * 4
    assert fn() == pytest.approx(max(bytes_ / 3.35e12, ops / 67e12), rel=1e-12)


def test_every_kernel_file_names_a_launcher_of_the_program():
    import glob

    for path in glob.glob(os.path.join(harness.BENCH, "kernels", "*.py")):
        name = os.path.basename(path)[:-3]
        if name == "__init__":
            continue
        k = _kernel(name)
        mod = importlib.import_module(k.MODULE)
        assert callable(getattr(mod, k.FUNCTION)), name

