"""Port parity: engine/descriptor.py (umfa_tpu/engine/descriptor.py).

The same inputs, from a numpy seed, through JAX's descriptor (its kernels in
interpret mode) and the port's (its plain versions on the CPU): fp32
atol = rtol = 2e-5 (TOL["fp32"]: the same arithmetic summed in other
orders).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.engine import descriptor as jdesc
from umfa_tpu.engine.config import Precision as JPrecision
from umfa_tpu.ops.flash_fwd import BlockSizes as JBlockSizes
from umfa_tpu_torch.engine import descriptor
from umfa_tpu_torch.engine.config import Precision
from umfa_tpu_torch.ops.flash_fwd import BlockSizes

FP32 = dict(atol=2e-5, rtol=2e-5)


def test_hashing_and_equality():
    shape = descriptor.MultiHeadShape(1, 2, 64, 64)
    d1 = descriptor.AttentionDescriptor(shape=shape, sparsity=descriptor.SparsityPattern.CAUSAL)
    d2 = descriptor.AttentionDescriptor(shape=descriptor.MultiHeadShape(1, 2, 64, 64),
                                        sparsity=descriptor.SparsityPattern.CAUSAL)
    assert d1 == d2 and hash(d1) == hash(d2) and len({d1, d2}) == 1
    assert d1 != descriptor.AttentionDescriptor(shape=shape)
    assert d1 != dataclasses.replace(d1, block_sizes=BlockSizes(128, 256))
    assert d1.causal and shape.bhsd == (1, 2, 64, 64)
    assert dataclasses.replace(d1, input_precision=Precision.FP32).tdtype == torch.float32
    assert d1.tdtype == torch.bfloat16
    with pytest.raises(dataclasses.FrozenInstanceError):
        d1.softmax_scale = 0.5
    with pytest.raises(ValueError):
        descriptor.AttentionDescriptor(shape=shape, low_precision_intermediates=True)
    with pytest.raises(ValueError):
        descriptor.AttentionDescriptor(shape=shape,
                                       sparsity=descriptor.SparsityPattern.SLIDING_WINDOW)


CASES = {
    # name: (B, Hq, Hkv, S, D, descriptor kwargs, call mask)
    "causal": (1, 2, 2, 64, 64, dict(sparsity="CAUSAL"), None),
    "gqa_scale": (2, 4, 2, 48, 32, dict(sparsity="CAUSAL", softmax_scale=0.3), None),
    "window": (1, 2, 2, 96, 32, dict(sparsity="SLIDING_WINDOW", window=(16, 0)), None),
    "mask_mod_tiles": (1, 2, 2, 256, 32, dict(block_sizes=(128, 128)),
                       lambda q, k: (q // 64) == (k // 64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_descriptor_run_matches_jax(case):
    b, hq, hkv, s, d, kw, mask = CASES[case]
    rng = np.random.default_rng(3)
    q = rng.normal(0, 1, (b, hq, s, d)).astype(np.float32)
    k, v = (rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32) for _ in range(2))

    def make(mod, blocks, prec):
        args = dict(kw, sparsity=getattr(mod.SparsityPattern, kw.get("sparsity", "NONE")),
                    input_precision=prec)
        if "block_sizes" in args:
            args["block_sizes"] = blocks(*args["block_sizes"])
        return mod.AttentionDescriptor(shape=mod.MultiHeadShape(b, hq, s, d), num_kv_heads=hkv,
                                       **args)

    jd = make(jdesc, JBlockSizes, JPrecision.FP32)
    td = make(descriptor, BlockSizes, Precision.FP32)
    want = jd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, interpret=True)
    got = td(*(torch.from_numpy(a) for a in (q, k, v)), mask)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_capabilities_have_the_references_keys():
    caps, jcaps = descriptor.get_quantized_capabilities(), jdesc.get_quantized_capabilities()
    assert sorted(caps) == sorted(jcaps)
    assert caps["multi_head_backward"] and caps["blockwise_backward"]
    assert caps["int8"] and caps["int4"] and caps["max_heads"] >= 128 and caps["native_bfloat"]
