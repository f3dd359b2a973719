"""Dense flash-attention backward (port of umfa_tpu/ops/flash_bwd.py).

`flash_attention_backward` launches the CUDA kernels `csrc/flash_bwd.cu`
(dQ, then dK/dV: one launch each) on CUDA tensors, all on the tensor cores,
at any head_dim (above 256 the wide bodies of `csrc/wide_tc.cuh`, the
scores built up through the depth in chunks, one block per column slice,
as `umfa_flash_wide_plan` reports): bf16 inputs as bf16 products; fp32
inputs (and fp16, computed as fp32) as 3xTF32 products (each fp32 operand split
into two TF32 parts, three products each, as accurate as fp32 FMAs in
another order: relerr ~1e-7 to 1e-6 against the plain version, not
bit-equal).
`flash_attention_bias_grad` launches `csrc/flash_dbias.cu` (one launch),
on the tensor cores for every input type and head_dim: bf16 products for
bf16 inputs, 3xTF32 for fp32 (and fp16, computed as fp32).
On CPU tensors each runs its `*_plain` twin, the same arithmetic in plain
PyTorch. There is no fallback between the two: a CUDA tensor the kernels
do not take raises.

Semantics (the reference's, flash_bwd.py:45-69, :699-701, :825-1274):
  * P is recomputed from the saved LSE, P = exp(Q·scale·Kᵀ + bias − LSE),
    and is 0 where causal, window or the KV tail hide a key (top-left
    aligned); dS = P∘(dP − δ) with dP = dO·Vᵀ;
  * δ = rowsum(dO∘O) − dlse in fp32, outside the kernels (:917-922): a
    cotangent on LSE folds in there;
  * rows whose LSE is at the mask value (no visible key) get LSE +1e30,
    so their P and their gradients are exactly 0 (:939-944);
  * bf16 inputs round Q·scale, P and dS to the input type where the TPU
    kernel does, and dO is cast to V's type; fp32 inputs round nowhere;
    accumulation is fp32 and the store type is `grad_dtype` (fp32 or bf16;
    fp32 when None); fp16 inputs are storage-only: computed as fp32;
  * dK/dV of a GQA group are summed inside the kernel;
  * the bias gradient is dS unscaled, summed over the bias's broadcast
    batch and head dimensions; it uses the LSE as given and δ without the
    LSE cotangent, as the reference does (flash_bwd.py:737);
  * a block-sparse map (`block_map`, ops/flash_fwd.py `Walk`) hides the
    unwalked pairs as the forward does (P = 0); on the card the dQ kernel
    walks `fetch_kv` and the dK/dV kernel `fetch_q`, for each query head of
    its GQA group that head's own row; the bias gradient is not walked, as
    the reference's is not (umfa_tpu/ops/attention.py:80-97).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from umfa_tpu_torch import _kernels
from umfa_tpu_torch.ops.flash_fwd import (
    DEFAULT_MASK_VALUE,
    WALK_ARGTYPES,
    Walk,
    _DTYPE_CODE,
    _prepare as _prepare_operands,
    bias_strides,
    make_walk,
    refuse_wide,
    visible_mask,
    walk_args,
    walked_keys,
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_BWD_ARGTYPES = (*(_P,) * 9, *(_I,) * 6, *(_L,) * 4, ctypes.c_float, _I, _I, _I, _I,
                 *WALK_ARGTYPES, _P)
_DBIAS_ARGTYPES = (*(_P,) * 8, *(_I,) * 8, *(_L,) * 4, ctypes.c_float, _I, _I, _I, _P)


class _Prepared(NamedTuple):
    q: torch.Tensor       # (B, Hq, Sq, D), fp32 or bf16, contiguous
    k: torch.Tensor       # (B, Hkv, Sk, D), q's dtype, contiguous
    v: torch.Tensor
    do: torch.Tensor      # (B, Hq, Sq, D) in v's dtype, contiguous
    lse: torch.Tensor     # (B, Hq, Sq) fp32
    delta: torch.Tensor   # (B, Hq, Sq) fp32
    bias: Optional[torch.Tensor]  # fp32 view expanded to (B, Hq, Sq, Sk)
    scale: float
    left: int
    right: int
    walk: Optional[Walk] = None


def _prepare(q, k, v, out, lse, do, bias, dlse, causal, window, scale,
             walk: Optional[Walk] = None) -> _Prepared:
    p = _prepare_operands(q, k, v, bias, causal, window, scale, None, walk)
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} and out {tuple(out.shape)} must match q {tuple(q.shape)}")
    if lse.shape != q.shape[:3]:
        raise ValueError(f"lse shape {tuple(lse.shape)} != {tuple(q.shape[:3])}")
    delta = (do.float() * out.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return _Prepared(p.q.contiguous(), p.k.contiguous(), p.v.contiguous(),
                     do.to(p.v.dtype).contiguous(), lse.float().contiguous(), delta.contiguous(),
                     p.bias, p.scale, p.left, p.right, p.walk)


def _kernel_lse(lse: torch.Tensor) -> torch.Tensor:
    """Rows with no visible key carry LSE at the mask value; +1e30 makes
    their recomputed P underflow to exactly 0 (flash_bwd.py:939-944)."""
    return torch.where(lse <= DEFAULT_MASK_VALUE * 0.5, -DEFAULT_MASK_VALUE, lse)


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dlse: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: Optional[tuple] = None,
    scale: Optional[float] = None,
    grad_dtype: Optional[torch.dtype] = None,
    block_map: Optional[torch.Tensor] = None,
    fetch_kv: Optional[torch.Tensor] = None,
    fetch_q: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
):
    """FA2 backward. q, out, do: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D);
    lse, dlse: (B, Hq, Sq); bias, block_map, block_q and block_k as in the
    forward, fetch_kv and fetch_q the map's compacted tables. Returns
    (dq, dk, dv) in `grad_dtype` (default fp32), dk/dv per KV head (the GQA
    group summed)."""
    return _backward(q, k, v, out, lse, do, bias, dlse, causal=causal, window=window,
                     scale=scale, grad_dtype=grad_dtype,
                     walk=make_walk(block_map, fetch_kv, fetch_q, block_q, block_k))


def _backward(q, k, v, out, lse, do, bias, dlse, *, causal, window, scale, grad_dtype,
              walk: Optional[Walk]):
    """`flash_attention_backward` with its block-sparse arguments as a Walk."""
    grad_dtype = grad_dtype or torch.float32
    if grad_dtype not in _DTYPE_CODE:
        raise ValueError(f"grad_dtype must be float32 or bfloat16, got {grad_dtype}")
    p = _prepare(q, k, v, out, lse, do, bias, dlse, causal, window, scale, walk)
    if p.q.device.type == "cpu":
        return tuple(g.to(grad_dtype) for g in _plain(p))
    return _launch(p, grad_dtype)


def flash_attention_backward_plain(
    q, k, v, out, lse, do, bias=None, dlse=None, *, causal=False, window=None, scale=None,
    grad_dtype=None, block_map=None, fetch_kv=None, fetch_q=None, block_q=None, block_k=None,
):
    """The kernels' arithmetic in plain PyTorch, on any device. Same
    arguments and results as `flash_attention_backward`."""
    p = _prepare(q, k, v, out, lse, do, bias, dlse, causal, window, scale,
                 make_walk(block_map, fetch_kv, fetch_q, block_q, block_k))
    return tuple(g.to(grad_dtype or torch.float32) for g in _plain(p))


def _bias4_shape(bias: torch.Tensor, seq_q: int) -> tuple:
    """The bias's 4-D shape as the forward reads it: 2-D (Sq, Sk),
    3-D (B, Sq, Sk)."""
    shape = tuple(bias.shape)
    if len(shape) == 2:
        shape = (1, 1) + shape
    elif len(shape) == 3:
        shape = shape[:1] + (1,) + shape[1:]
    elif len(shape) != 4:
        raise ValueError(f"bias must be 2-D to 4-D, got shape {tuple(bias.shape)}")
    if shape[2] != seq_q:
        # The reference asserts the same (flash_bwd.py:733); the autograd
        # wrapper (ops/attention.py) expands a q-broadcast bias first.
        raise ValueError("q-broadcast bias: expand it to Sq first and sum the gradient after")
    return shape


def flash_attention_bias_grad(
    q, k, v, out, lse, do, bias, *, causal=False, window=None, scale=None,
):
    """dL/dbias as fp32 (Bb, Hb, Sq, Sk), the bias's own 4-D shape (2-D =
    (Sq, Sk), 3-D = (B, Sq, Sk)): dS unscaled, summed over the bias's
    broadcast batch and head dimensions."""
    shape = _bias4_shape(bias, q.shape[2])
    p = _prepare(q, k, v, out, lse, do, bias, None, causal, window, scale)
    if p.q.device.type == "cpu":
        return _plain_dbias(p, shape)
    return _launch_dbias(p, shape)


def flash_attention_bias_grad_plain(
    q, k, v, out, lse, do, bias, *, causal=False, window=None, scale=None,
):
    """The dbias kernel's arithmetic in plain PyTorch, on any device."""
    shape = _bias4_shape(bias, q.shape[2])
    p = _prepare(q, k, v, out, lse, do, bias, None, causal, window, scale)
    return _plain_dbias(p, shape)


def _plain_p_ds(p: _Prepared, lse: torch.Tensor):
    """Recomputed P and dS = P∘(dP − δ), both fp32 (B, Hq, Sq, Sk)."""
    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    g = hq // hkv
    qs = (p.q.float() * p.scale).to(p.q.dtype).float()
    # GQA: fold the group into the query rows (h = hk * g + gi).
    s = torch.matmul(qs.reshape(b, hkv, g * sq, d), p.k.float().transpose(-1, -2))
    s = s.reshape(b, hq, sq, sk)
    if p.bias is not None:
        s += p.bias
    hidden = ~visible_mask(sq, sk, p.left, p.right, s.device)
    if p.walk is not None:
        hidden = hidden | ~walked_keys(p.walk, sq, sk)
    pm = s.sub_(lse[..., None]).exp_().masked_fill_(hidden, 0.0)
    dp = torch.matmul(p.do.float().reshape(b, hkv, g * sq, d), p.v.float().transpose(-1, -2))
    ds = dp.reshape(b, hq, sq, sk).sub_(p.delta[..., None]).mul_(pm)
    return pm, ds


def _plain(p: _Prepared):
    return (_plain_dq(p), *_plain_dkv(p))


def _plain_dq(p: _Prepared) -> torch.Tensor:
    """dQ = scale · round(dS)·K, as the dQ kernel (which recomputes P)."""
    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    _, ds = _plain_p_ds(p, _kernel_lse(p.lse))
    dsr = ds.to(p.q.dtype).float().reshape(b, hkv, hq // hkv * sq, sk)  # dS rounded
    del ds
    return torch.matmul(dsr, p.k.float()).mul_(p.scale).reshape(b, hq, sq, d)


def _plain_dkv(p: _Prepared):
    """dK = scale · round(dS)ᵀ·Q and dV = round(P)ᵀ·dO, the GQA group
    summed, as the dK/dV kernel (which recomputes P)."""
    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    rows = hq // hkv * sq  # GQA: the group folded into the query rows
    pm, ds = _plain_p_ds(p, _kernel_lse(p.lse))
    pr = pm.to(p.q.dtype).float().reshape(b, hkv, rows, sk)  # P rounded
    del pm
    dv = torch.matmul(pr.transpose(-1, -2), p.do.float().reshape(b, hkv, rows, d))
    del pr
    dsr = ds.to(p.q.dtype).float().reshape(b, hkv, rows, sk)  # dS rounded
    del ds
    dk = torch.matmul(dsr.transpose(-1, -2), p.q.float().reshape(b, hkv, rows, d))
    return dk.mul_(p.scale), dv


def _plain_dbias(p: _Prepared, shape: tuple) -> torch.Tensor:
    _, ds = _plain_p_ds(p, p.lse)
    if shape[0] == 1:
        ds = ds.sum(dim=0, keepdim=True)
    if shape[1] == 1:
        ds = ds.sum(dim=1, keepdim=True)
    return ds


def _check_device(p: _Prepared, name: str) -> None:
    tensors = (p.q, p.k, p.v, p.do, p.lse, p.delta) + ((p.bias,) if p.bias is not None else ())
    if p.q.device.type != "cuda" or any(t.device != p.q.device for t in tensors):
        raise ValueError(f"{name} kernel needs every operand on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    if p.walk is not None:
        refuse_wide(f"the block-sparse walk of {name}", p.q.shape[3])


def _launch(p: _Prepared, store_dtype: torch.dtype):
    _check_device(p, "flash_bwd")
    return (_launch_dq(p, store_dtype), *_launch_dkv(p, store_dtype))


def _launch_dq(p: _Prepared, store_dtype: torch.dtype) -> torch.Tensor:
    dq = torch.empty(p.q.shape, dtype=store_dtype, device=p.q.device)
    if dq.numel() and p.k.numel():
        _run_bwd_kernel("flash_bwd_dq", p, dq, None)
    else:
        dq.zero_()
    return dq


def _launch_dkv(p: _Prepared, store_dtype: torch.dtype):
    dk = torch.empty(p.k.shape, dtype=store_dtype, device=p.k.device)
    dv = torch.empty(p.k.shape, dtype=store_dtype, device=p.k.device)
    if dk.numel() and p.q.numel():
        _run_bwd_kernel("flash_bwd_dkv", p, dk, dv)
    else:
        dk.zero_()
        dv.zero_()
    return dk, dv


def _run_bwd_kernel(kernel: str, p: _Prepared, out0: torch.Tensor, out1) -> None:
    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    bsb, bsh, bsq, bsk = bias_strides(p.bias)
    lse = _kernel_lse(p.lse)  # held until the launch is queued
    walk = walk_args(p.walk, "fetch_q" if out1 is not None else "fetch_kv", p.q.device)
    fn = _kernels.function("flash_bwd", f"umfa_{kernel}", _BWD_ARGTYPES)
    with torch.cuda.device(p.q.device):
        err = fn(
            p.q.data_ptr(), p.k.data_ptr(), p.v.data_ptr(), p.do.data_ptr(),
            lse.data_ptr(), p.delta.data_ptr(),
            None if p.bias is None else p.bias.data_ptr(),
            out0.data_ptr(), None if out1 is None else out1.data_ptr(),
            b, hq, hkv, sq, sk, d, bsb, bsh, bsq, bsk, p.scale, p.left, p.right,
            _DTYPE_CODE[p.q.dtype], _DTYPE_CODE[out0.dtype],
            *walk,
            torch.cuda.current_stream(p.q.device).cuda_stream,
        )
    _kernels.check("flash_bwd", err, kernel)


def _launch_dbias(p: _Prepared, shape: tuple) -> torch.Tensor:
    _check_device(p, "flash_dbias")
    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    bb, bh = shape[:2]
    dbias = torch.empty((bb, bh, sq, sk), dtype=torch.float32, device=p.q.device)
    if dbias.numel() == 0 or p.q.numel() == 0:
        return dbias.zero_()
    bsb, bsh, bsq, bsk = bias_strides(p.bias)
    fn = _kernels.function("flash_dbias", "umfa_flash_dbias", _DBIAS_ARGTYPES)
    with torch.cuda.device(p.q.device):
        err = fn(
            p.q.data_ptr(), p.k.data_ptr(), p.v.data_ptr(), p.do.data_ptr(),
            p.lse.data_ptr(), p.delta.data_ptr(), p.bias.data_ptr(), dbias.data_ptr(),
            b, hq, hkv, sq, sk, d, bb, bh, bsb, bsh, bsq, bsk, p.scale, p.left, p.right,
            _DTYPE_CODE[p.q.dtype], torch.cuda.current_stream(p.q.device).cuda_stream,
        )
    _kernels.check("flash_dbias", err)
    _kernels.launches[f"flash_dbias/{str(p.q.dtype).removeprefix('torch.')}"] += 1
    return dbias
