"""Port parity: the tensor-core probe (`utils/mma_probe.py`) against the
reference's `_mxu_probe_fn` (scripts/d64_ab.py:64), loaded from the script
with importlib and run in interpret mode, at M 256 and reps 8 for the K and
N of its five probe shapes.

Tolerance: fp32 relerr 1e-5 (bf16 products are exact in fp32; the two sum
them in another order).
"""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from umfa_tpu_torch.utils.mma_probe import SHAPES, mma_probe, mma_probe_plain
from umfa_tpu_torch.utils.testing import rel_err

REPO = pathlib.Path(__file__).resolve().parents[1]


def _reference():
    spec = importlib.util.spec_from_file_location("d64_ab", REPO / "scripts" / "d64_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(k, n):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(0, 1, (256, k)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.normal(0, 1e-3, (k, n)).astype(np.float32)).bfloat16()
    return a, b


def test_shapes_are_the_reference_probes():
    ref = _reference()
    assert SHAPES == {name: spec[1:] for name, spec in ref.VARIANTS.items() if spec[0] == "mxu"}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_probe_matches_reference(name):
    _, k, n = SHAPES[name]
    a, b = _operands(k, n)
    fn = jax.jit(_reference()._mxu_probe_fn(256, k, n, 8, True))
    to_jax = lambda t: jax.numpy.asarray(t.float().numpy(), jax.numpy.bfloat16)  # noqa: E731
    want = np.asarray(fn(to_jax(a), to_jax(b)))
    got = mma_probe_plain(a, b, 8)
    assert got.dtype == torch.float32 and got.shape == (256, n)
    assert rel_err(got, want) <= 1e-5
    # On CPU tensors the wrapper runs the plain version.
    assert torch.equal(mma_probe(a, b, 8), got)


def test_probe_refuses_other_operands():
    a, b = _operands(64, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        mma_probe(a.float(), b, 2)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        mma_probe(a, b[:32], 2)
