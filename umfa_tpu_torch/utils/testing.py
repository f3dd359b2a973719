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


def lse_f64(q, k, bias, rows, *, keep=None, scale=None) -> torch.Tensor:
    """The plain forward's LSE (ops/flash_fwd.py `_plain`) of `rows`, an
    (n, 3) tensor of (batch, head, query) indices, with its rounding points
    (Q·scale rounded to q's dtype, P rounded to it before the row sum at
    D < 128) and every sum in float64. keep: a bool mask broadcastable to
    (B, Hq, Sq, Sk) of the keys a row may see (e.g. a walk's keys), or
    None. Where a kernel and the fp32 plain version round one bf16(P) of a
    short row apart, this says which one holds the arithmetic."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    bi, hi, qi = rows.unbind(1)
    scale = d**-0.5 if scale is None else scale
    qs = (q[bi, hi, qi].float() * scale).to(q.dtype).double()
    s = torch.einsum("nd,nkd->nk", qs, k[bi, hi // (hq // k.shape[1])].double())
    if bias is not None:
        s = s + bias.expand(b, hq, sq, sk)[bi, hi, qi].double()
    if keep is not None:
        s = s.masked_fill(~keep.expand(b, hq, sq, sk)[bi, hi, qi], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if d < 128:
        p = p.to(q.dtype).double()
    return m[:, 0] + torch.log(p.sum(dim=-1))


def lse_check(lse, want_lse, q, k, bias, tol, *, keep=None, max_rows=32) -> dict:
    """A kernel's LSE against its plain version's on the rows that see a
    key, at `tol`; a row past `tol` (at most `max_rows` of them) passes only
    if it is within `tol` of `lse_f64` of the same row."""
    vis = want_lse > -1e29
    err = (lse.float() - want_lse.float()).abs().where(vis, torch.zeros_like(want_lse))
    over = torch.nonzero(err > tol)
    res = {"max_abs_lse": float(err.max()) if err.numel() else 0.0,
           "lse_rows_over_tol": int(over.shape[0]), "max_abs_lse_f64_on_those_rows": None}
    ok = over.shape[0] == 0
    if 0 < over.shape[0] <= max_rows:
        ref = lse_f64(q, k, bias, over, keep=keep)
        worst = float((lse[tuple(over.T)].double() - ref).abs().max())
        res["max_abs_lse_f64_on_those_rows"] = worst
        ok = worst <= tol
    res["lse_ok"] = ok
    return res
