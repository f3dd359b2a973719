"""Tolerance policy and error metrics (mirror of umfa_tpu/utils/testing.py).

`rel_err` and `cosine` take numpy arrays or torch tensors (any device) and
compute in float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

TOL = {
    "fp32": dict(atol=2e-5, rtol=2e-5),
    "bf16": dict(atol=2e-2, rtol=2e-2),
    "fp16": dict(atol=2e-3, rtol=2e-3),
}

INT8_REL_ERR = 0.02   # kernel-level envelope; end-to-end target ≈0.1%


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    denom = np.linalg.norm(want)
    if denom == 0:
        return float(np.linalg.norm(got))
    return float(np.linalg.norm(got - want) / denom)


def cosine(a, b) -> float:
    a, b = _f64(a).ravel(), _f64(b).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 1.0 if na == nb else 0.0
    return float(a @ b / (na * nb))
