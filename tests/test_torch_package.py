"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "umfa_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax():
    mods = list(_modules())
    assert "umfa_tpu_torch.models.gpt" in mods and len(mods) >= 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.') or m == 'umfa_tpu'\n"
        "             or m.startswith('umfa_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|umfa_tpu\b(?!_torch))", re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_entry_points_default_to_the_card():
    from umfa_tpu_torch.models import gpt
    from umfa_tpu_torch.serving.kv_cache import init_cache
    from umfa_tpu_torch.utils.device import default_device

    cfg = gpt.GPTConfig(vocab=32, dim=64, num_heads=2, num_kv_heads=1, depth=1, max_seq=16)
    calls = (default_device, lambda: gpt.init_params(cfg), lambda: gpt.init_caches(cfg, 1),
             lambda: init_cache(1, 1, 8, 8))
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
        assert gpt.init_params(cfg).embed.is_cuda
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert default_device("cpu").type == "cpu"
    assert gpt.init_caches(cfg, 1, device="cpu")[0].k.device.type == "cpu"


def test_error_metrics_take_numpy_and_torch():
    import numpy as np

    from umfa_tpu_torch.utils.testing import INT8_REL_ERR, cosine, rel_err

    a = np.array([3.0, 4.0])
    b = torch.tensor([3.0, 4.5], dtype=torch.bfloat16)
    assert rel_err(b, a) == pytest.approx(0.1)
    assert rel_err(a, np.zeros(2)) == pytest.approx(5.0)
    assert cosine(a, torch.tensor([6.0, 8.0])) == pytest.approx(1.0)
    assert cosine(np.zeros(2), np.zeros(2)) == 1.0 and cosine(a, np.zeros(2)) == 0.0
    assert INT8_REL_ERR == 0.02
