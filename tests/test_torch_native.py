"""The port's binding of the native runtime (umfa_tpu_torch/native/runtime.py).

The port builds `native/src/umfa_runtime.cpp` itself into its `_build/`
and never loads `native/build/libumfa_runtime.so`, so its counters stay
apart from the JAX package's in one process. The quantizer's codes and
scales equal the JAX binding's bit for bit: one C++ source, one input.
"""

import numpy as np
import pytest

from umfa_tpu.native import runtime as jrt
from umfa_tpu_torch.engine import stats
from umfa_tpu_torch.native import runtime


@pytest.fixture
def jax_runtime(monkeypatch):
    # The JAX binding loads the library native/Makefile built; it never
    # builds one here.
    monkeypatch.setenv("UMFA_NO_NATIVE_BUILD", "1")
    assert jrt.available()
    return jrt


def test_builds_from_source_into_the_ports_build_dir():
    assert runtime.available()
    path = runtime.lib_path()
    assert path.exists() and path.parent == runtime.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "umfa_tpu_torch"
    assert "umfa_tpu-native" in runtime.version()
    assert str(path) != jrt._SO_PATH


def test_quantize_int8_rowwise_equals_the_jax_binding(jax_runtime):
    x = np.random.default_rng(0).normal(0, 2, (3, 5, 64)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row
    codes, scales = runtime.quantize_int8_rowwise(x)
    jcodes, jscales = jax_runtime.quantize_int8_rowwise(x)
    assert codes.dtype == np.int8 and codes.shape == x.shape and scales.shape == x.shape[:-1]
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(scales.view(np.uint32), jscales.view(np.uint32))


def test_counters_are_separate_from_the_jax_packages(jax_runtime):
    runtime.reset_dispatch_stats()
    jax_runtime.reset_dispatch_stats()
    runtime.record_dispatch("fused_fwd")
    runtime.record_dispatch("quantized_autograd")
    runtime.record_dispatch("no_such_route")  # counts in total only, as the reference
    jax_runtime.record_dispatch("naive_fallback")
    got, jgot = runtime.get_dispatch_stats(), jax_runtime.get_dispatch_stats()
    assert got["total"] == 3 and got["fused_fwd"] == 1 and got["quantized_autograd"] == 1
    assert got["naive_fallback"] == 0
    assert jgot == {**dict.fromkeys(jgot, 0), "total": 1, "naive_fallback": 1}
    runtime.record_latency_ns(1000)
    runtime.record_latency_ns(3000)
    jax_runtime.record_latency_ns(7)
    assert runtime.get_last_latency_ns() == 3000 and runtime.get_mean_latency_ns() > 0
    assert jax_runtime.get_last_latency_ns() == 7
    runtime.reset_dispatch_stats()
    assert runtime.get_dispatch_stats()["total"] == 0
    assert jax_runtime.get_dispatch_stats()["total"] == 1
    jax_runtime.reset_dispatch_stats()


def test_engine_stats_record_into_the_native_counters():
    stats.reset_dispatch_stats()
    stats.record_dispatch("naive_fallback")
    assert stats.get_dispatch_stats() == runtime.get_dispatch_stats()
    assert runtime.get_dispatch_stats()["naive_fallback"] == 1
    assert runtime.get_dispatch_stats()["total"] == 1
    stats.reset_dispatch_stats()


def test_a_failed_build_names_the_compiler_and_its_log(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "g++ -DUMFA_NO_SUCH_FLAG=1 -fno-such-option")
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_error", None)
    assert not runtime.available()
    with pytest.raises(RuntimeError, match="g\\+\\+.*fno-such-option") as err:
        runtime.version()
    assert "exit" in str(err.value)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))

