"""Port parity: utils/checkpoint.py (umfa_tpu/utils/checkpoint.py).

Round trips are bit-exact: restore gives back each saved tensor's bits, in
the template's dtype and on its device. `load_mla_weights` reads the same
`.npz` as JAX's, bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.utils import checkpoint as jcheckpoint
from umfa_tpu_torch.engine.config import Precision, QuantMode
from umfa_tpu_torch.models import gpt
from umfa_tpu_torch.ops.gemm import quantize_weight
from umfa_tpu_torch.ops.quant import quantize
from umfa_tpu_torch.utils import checkpoint


def _equal(a, b):
    assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_roundtrip(tmp_path, dtype):
    cfg = gpt.GPTConfig(vocab=64, dim=64, num_heads=4, num_kv_heads=2, depth=2, max_seq=32,
                        dtype=dtype)
    model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = model.state_dict()
    path = str(tmp_path / "sub" / "gpt.pt")
    checkpoint.save(path, state)
    like = {n: torch.zeros_like(t) for n, t in state.items()}
    back = checkpoint.restore(path, like)
    assert list(back) == list(state)
    for n, t in state.items():
        _equal(back[n], t)
    fresh = gpt.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    fresh.load_state_dict(back)
    for (n, a), b in zip(fresh.state_dict().items(), state.values()):
        _equal(a, b)


def test_nested_tree_with_quantized_leaves_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (1, 2, 64, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (64, 32)).astype(np.float32))
    tree = {"int8": quantize(x), "int4_block": quantize(x, Precision.INT4, QuantMode.BLOCK),
            "w8": quantize_weight(w), "w4c": quantize_weight(w, Precision.INT4, center=True),
            "list": [x[0, 0, :3], (w[:2], torch.arange(5))], "none": None}
    path = str(tmp_path / "tree.pt")
    checkpoint.save(path, tree)
    back = checkpoint.restore(path, tree)
    for name in ("int8", "int4_block", "w8", "w4c"):
        a, b = tree[name], back[name]
        assert type(a) is type(b)
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, torch.Tensor):
                _equal(vb, va)
            else:
                assert va == vb, (name, f.name)
    _equal(back["list"][0], tree["list"][0])
    assert isinstance(back["list"][1], tuple)
    _equal(back["list"][1][1], tree["list"][1][1])
    assert back["none"] is None


def test_restore_takes_the_templates_dtype_and_refuses_other_shapes(tmp_path):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    path = str(tmp_path / "t.pt")
    checkpoint.save(path, {"t": t})
    back = checkpoint.restore(path, {"t": torch.zeros((2, 3), dtype=torch.float64)})
    assert back["t"].dtype == torch.float64 and torch.equal(back["t"], t.double())
    with pytest.raises(ValueError):
        checkpoint.restore(path, {"t": torch.zeros((3, 2))})
    with pytest.raises(KeyError):
        checkpoint.restore(path, {"u": t})
    with pytest.raises(TypeError):
        checkpoint.save(path, {"s": "a string"})


def test_load_mla_weights_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    w_k = rng.normal(0, 1, (32, 256)).astype(np.float32)
    w_v = rng.normal(0, 1, (32, 256)).astype(np.float32)
    path = str(tmp_path / "mla.npz")
    np.savez(path, w_k=w_k, w_v=w_v)
    jk, jv = jcheckpoint.load_mla_weights(path, 32, 256)
    k, v = checkpoint.load_mla_weights(path, 32, 256, device="cpu")
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    k2, v2 = checkpoint.load_mla_weights((torch.from_numpy(w_k), w_v), 32, 256, device="cpu")
    assert torch.equal(k2, k) and torch.equal(v2, v)
    jk3, _ = jcheckpoint.load_mla_weights((jnp.asarray(w_k), jnp.asarray(w_v)), 32, 256)
    np.testing.assert_array_equal(k2.numpy(), np.asarray(jk3))
    with pytest.raises(ValueError):
        checkpoint.load_mla_weights((w_k, w_v), 16, 256, device="cpu")
