"""STE backward on quantized residuals (port of umfa_tpu/ops/quant_bwd.py
`quantized_attention_backward`).

`quantized_attention_backward` launches the CUDA kernels `csrc/quant_bwd.cu`
(`quant_bwd_dq`, then `quant_bwd_dkv`, both on the tensor cores; head_dim
<= 256) on CUDA tensors and runs `quantized_attention_backward_plain`, the
same arithmetic in plain PyTorch, on CPU tensors; no fallback between them.

What the TPU kernels compute (quant_bwd.py:65-98, :205-251, :448-495), the
gradients of the fake-quantized forward on the int8/int4 residuals:
  * operands dequantized on load to bf16: q̃ = bf16(code_q · (sq·scale))
    (softmax scale folded into Q's scale first), k̃ = bf16(code_k · sk),
    ṽ = bf16(code_v · sv); INT4 codes unpacked from split halves first;
  * P = exp(q̃·k̃ + corr·scale + bias − lse), 0 where causal, window or the
    KV tail hide the key;
  * dP = bf16(dO)·ṽ, plus Σ_d dO·vm per row when vm is given (dO in fp32);
  * dS = P∘(dP − δ); dQ = scale · bf16(dS)·k̃; dV = bf16(P)ᵀ·bf16(dO);
    dK = bf16(dS)ᵀ·q̃ (q̃ carries the scale) + scale·colsum(dS)ᵀ·qm per query
    head, the GQA group summed;
  * fp32 accumulation, stored in `grad_dtype` (default fp32).
Plain torch, as in the reference (:647-671): δ = rowsum(dO∘O) − dlse in
fp32, and LSE +1e30 for rows with no visible key, so their gradients are 0.
Scales come per row (…, S, 1) or per (b, h) (…, 1, 1). The port does not
run the "int8 S recompute" that the comment at quant_attention.py:892-894
claims; the kernels dequantize on load, as the reference's kernels do.
SYMMETRIC residuals only, as in the reference (quant_bwd.py:34-37):
ASYMMETRIC ones go through the dense backward on the dequantized operands
(`ops/quant_attention.py` `_QFlash.backward`). A block-sparse map
(`block_map` with block_q, block_k) hides the unwalked pairs as the dense
backward does (P = 0); on the card the dQ kernel walks `fetch_kv` and the
dK/dV kernel `fetch_q`, each query head of its GQA group its own row, the
corr row and the Q-mean term taken at each head's own first and last
walked tile.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from umfa_tpu_torch import _kernels
from umfa_tpu_torch.engine.config import Precision, QuantStrategy
from umfa_tpu_torch.ops.flash_bwd import _kernel_lse
from umfa_tpu_torch.ops.flash_fwd import (
    WALK_ARGTYPES,
    Walk,
    _DTYPE_CODE,
    _check_walk,
    bias_strides,
    broadcast_bias,
    fold_mask,
    make_walk,
    refuse_wide,
    visible_mask,
    walk_args,
    walked_keys,
)
from umfa_tpu_torch.ops.quant import QuantizedTensor, unpack_int4

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# qv kv vv qs ks vs do lse delta qm vm corr bias out0 out1 | B Hq Hkv Sq Sk D |
# qs_rows ks_rows vs_rows | bsb bsh bsq bsk | scale left right | int4 flags |
# do dtype, out dtype | the walk | stream
_ARGTYPES = (*(_P,) * 15, *(_I,) * 6, *(_I,) * 3, *(_L,) * 4, ctypes.c_float, _I, _I,
             _I, _I, _I, *WALK_ARGTYPES, _P)


class _Prepared(NamedTuple):
    q: torch.Tensor        # int8 codes (B, Hq, Sq, D or D/2), contiguous
    k: torch.Tensor        # (B, Hkv, Sk, D or D/2)
    v: torch.Tensor
    q_scales: torch.Tensor  # fp32 (B, Hq, Sq|1, 1), softmax scale folded in
    k_scales: torch.Tensor  # fp32 (B, Hkv, Sk|1, 1)
    v_scales: torch.Tensor
    q_int4: bool
    k_int4: bool
    v_int4: bool
    do: torch.Tensor       # (B, Hq, Sq, D) fp32 or bf16, contiguous
    lse: torch.Tensor      # (B, Hq, Sq) fp32, masked rows already +1e30
    delta: torch.Tensor    # (B, Hq, Sq) fp32
    qm: Optional[torch.Tensor]    # (B, Hq, D) fp32
    vm: Optional[torch.Tensor]    # (B, Hkv, D) fp32
    corr: Optional[torch.Tensor]  # (B, Hq, Sk) fp32, times scale
    bias: Optional[torch.Tensor]  # fp32 view expanded to (B, Hq, Sq, Sk)
    shape: tuple           # (B, Hq, Hkv, Sq, Sk, D)
    scale: float
    left: int
    right: int
    walk: Optional[Walk]


def _scales(t, b, h, s, name) -> torch.Tensor:
    if t.dim() != 4 or tuple(t.shape[:2]) != (b, h) or t.shape[2] not in (1, s) or t.shape[3] != 1:
        raise ValueError(f"{name} scales of shape {tuple(t.shape)}; expected ({b}, {h}, {s} or 1, 1)")
    return t.float().contiguous()


def _prepare(qt_q, qt_k, qt_v, out, lse, do, qm, vm, score_corr, bias, dlse,
             causal, window, scale, walk: Optional[Walk] = None) -> _Prepared:
    for qt in (qt_q, qt_k, qt_v):
        if not isinstance(qt, QuantizedTensor) or not qt.precision.is_integer:
            raise ValueError("quantized_attention_backward takes INT8/INT4 QuantizedTensors")
        if qt.strategy != QuantStrategy.SYMMETRIC:
            raise ValueError(
                "quantized_attention_backward takes SYMMETRIC residuals; ASYMMETRIC ones "
                "take the dequantize-and-dense route (dequantize, then "
                "ops.flash_bwd.flash_attention_backward), as quantized_flash_attention's "
                "backward does")
    b, hq, sq, d = qt_q.orig_shape
    _, hkv, sk, dk_ = qt_k.orig_shape
    if tuple(qt_v.orig_shape) != tuple(qt_k.orig_shape) or dk_ != d or qt_k.orig_shape[0] != b:
        raise ValueError(f"residual shapes {qt_q.orig_shape}/{qt_k.orig_shape}/{qt_v.orig_shape} do not match")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads {hq} must be a multiple of kv heads {hkv}")
    for qt, heads, s in ((qt_q, hq, sq), (qt_k, hkv, sk), (qt_v, hkv, sk)):
        w = d // 2 if qt.precision == Precision.INT4 else d
        if tuple(qt.values.shape) != (b, heads, s, w) or qt.values.dtype != torch.int8:
            raise ValueError(f"int8 values of shape {tuple(qt.values.shape)}; expected {(b, heads, s, w)}")
    if tuple(out.shape) != (b, hq, sq, d) or tuple(do.shape) != (b, hq, sq, d):
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} must be {(b, hq, sq, d)}")
    if tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"lse shape {tuple(lse.shape)} != {(b, hq, sq)}")
    scale = float(d**-0.5 if scale is None else scale)
    # Softmax scale folded into the Q scales (quant_bwd.py:680).
    q_scales = _scales(qt_q.scales, b, hq, sq, "q") * scale
    delta = (do.float() * out.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    do = do.float() if do.dtype == torch.float16 else do
    if do.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported do dtype {do.dtype}")
    if qm is not None:
        qm = qm.float().reshape(b, hq, d).contiguous()
    if vm is not None:
        vm = vm.float().reshape(b, hkv, d).contiguous()
    corr = None
    if score_corr is not None:
        corr = (score_corr.float() * scale).reshape(b, hq, sk).contiguous()
    if bias is not None:
        while bias.dim() < 4:
            bias = bias[None]
        bias = broadcast_bias(bias, b, hq, sq, sk)
    left, right = fold_mask(causal, window)
    if walk is not None:
        _check_walk(walk, b, hq, sq, sk)
    return _Prepared(
        qt_q.values.contiguous(), qt_k.values.contiguous(), qt_v.values.contiguous(),
        q_scales.contiguous(), _scales(qt_k.scales, b, hkv, sk, "k"),
        _scales(qt_v.scales, b, hkv, sk, "v"),
        qt_q.precision == Precision.INT4, qt_k.precision == Precision.INT4,
        qt_v.precision == Precision.INT4, do.contiguous(),
        _kernel_lse(lse.float()).contiguous(), delta.contiguous(), qm, vm, corr, bias,
        (b, hq, hkv, sq, sk, d), scale, left, right, walk)


def quantized_attention_backward(
    qt_q: QuantizedTensor,
    qt_k: QuantizedTensor,
    qt_v: QuantizedTensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    qm: Optional[torch.Tensor] = None,
    vm: Optional[torch.Tensor] = None,
    score_corr: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    dlse: Optional[torch.Tensor] = None,
    block_map: Optional[torch.Tensor] = None,
    fetch_kv: Optional[torch.Tensor] = None,
    fetch_q: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: Optional[tuple] = None,
    scale: Optional[float] = None,
    grad_dtype: Optional[torch.dtype] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
):
    """STE backward consuming ROW/TENSOR symmetric INT8/INT4 residuals.
    qm (B, Hq, 1, D), vm (B, Hkv, 1, D): the smoothing means the forward
    subtracted; score_corr (B, Hq, 1, Sk): the Q-mean score row in raw dot
    units; block_map, fetch_kv, fetch_q, block_q and block_k: a block-sparse
    walk, as in ops/flash_bwd.py. Returns (dq, dk, dv) in `grad_dtype`
    (default fp32), dk/dv per KV head (the GQA group summed)."""
    return _backward(qt_q, qt_k, qt_v, out, lse, do, qm, vm, score_corr, bias, dlse,
                     causal=causal, window=window, scale=scale, grad_dtype=grad_dtype,
                     walk=make_walk(block_map, fetch_kv, fetch_q, block_q, block_k))


def _backward(qt_q, qt_k, qt_v, out, lse, do, qm, vm, score_corr, bias, dlse, *, causal,
              window, scale, grad_dtype, walk: Optional[Walk]):
    """`quantized_attention_backward` with its block-sparse arguments as a Walk."""
    grad_dtype = grad_dtype or torch.float32
    if grad_dtype not in _DTYPE_CODE:
        raise ValueError(f"grad_dtype must be float32 or bfloat16, got {grad_dtype}")
    p = _prepare(qt_q, qt_k, qt_v, out, lse, do, qm, vm, score_corr, bias, dlse,
                 causal, window, scale, walk)
    if p.q.device.type == "cpu":
        return tuple(g.to(grad_dtype) for g in (_plain_dq(p), *_plain_dkv(p)))
    return _launch(p, grad_dtype)


def quantized_attention_backward_plain(
    qt_q, qt_k, qt_v, out, lse, do, qm=None, vm=None, score_corr=None, bias=None, dlse=None,
    block_map=None, fetch_kv=None, fetch_q=None, *, causal=False, window=None, scale=None,
    grad_dtype=None, block_q=None, block_k=None,
):
    """The kernels' arithmetic in plain PyTorch, on any device. Same
    arguments and results as `quantized_attention_backward`."""
    p = _prepare(qt_q, qt_k, qt_v, out, lse, do, qm, vm, score_corr, bias, dlse,
                 causal, window, scale, make_walk(block_map, fetch_kv, fetch_q, block_q, block_k))
    return tuple(g.to(grad_dtype or torch.float32) for g in (_plain_dq(p), *_plain_dkv(p)))


def _deq(vals, scales, int4) -> torch.Tensor:
    """bf16(code · scale) as fp32 (quant_bwd.py:94-98)."""
    if int4:
        vals = unpack_int4(vals)
    return (vals.float() * scales).to(torch.bfloat16).float()


def _plain_p_ds(p: _Prepared):
    """Recomputed P and dS, both fp32 (B, Hq, Sq, Sk), and the operands."""
    b, hq, hkv, sq, sk, d = p.shape
    g = hq // hkv
    q_bf = _deq(p.q, p.q_scales, p.q_int4)
    k_bf = _deq(p.k, p.k_scales, p.k_int4)
    v_bf = _deq(p.v, p.v_scales, p.v_int4)
    # GQA: fold the group into the query rows (h = hk * g + gi).
    s = torch.matmul(q_bf.reshape(b, hkv, g * sq, d), k_bf.transpose(-1, -2)).reshape(b, hq, sq, sk)
    if p.corr is not None:
        s += p.corr[:, :, None, :]
    if p.bias is not None:
        s += p.bias
    hidden = ~visible_mask(sq, sk, p.left, p.right, s.device)
    if p.walk is not None:
        hidden = hidden | ~walked_keys(p.walk, sq, sk)
    pm = s.sub_(p.lse[..., None]).exp_().masked_fill_(hidden, 0.0)
    do_f = p.do.float()
    do_bf = do_f.to(torch.bfloat16).float()
    dp = torch.matmul(do_bf.reshape(b, hkv, g * sq, d), v_bf.transpose(-1, -2)).reshape(b, hq, sq, sk)
    if p.vm is not None:
        dp += (do_f * p.vm.repeat_interleave(g, dim=1)[:, :, None, :]).sum(dim=-1, keepdim=True)
    ds = dp.sub_(p.delta[..., None]).mul_(pm)
    return pm, ds, q_bf, k_bf, do_bf


def _plain_dq(p: _Prepared) -> torch.Tensor:
    """dQ = scale · bf16(dS)·k̃, as the dQ kernel (which recomputes P)."""
    b, hq, hkv, sq, sk, d = p.shape
    _, ds, _, k_bf, _ = _plain_p_ds(p)
    dsr = ds.to(torch.bfloat16).float().reshape(b, hkv, hq // hkv * sq, sk)
    del ds
    return torch.matmul(dsr, k_bf).mul_(p.scale).reshape(b, hq, sq, d)


def _plain_dkv(p: _Prepared):
    """dK = bf16(dS)ᵀ·q̃ + scale·colsum(dS)ᵀ·qm and dV = bf16(P)ᵀ·bf16(dO),
    the GQA group summed, as the dK/dV kernel (which recomputes P)."""
    b, hq, hkv, sq, sk, d = p.shape
    g = hq // hkv
    rows = g * sq  # GQA: the group folded into the query rows
    pm, ds, q_bf, _, do_bf = _plain_p_ds(p)
    pr = pm.to(torch.bfloat16).float().reshape(b, hkv, rows, sk)
    del pm
    dv = torch.matmul(pr.transpose(-1, -2), do_bf.reshape(b, hkv, rows, d))
    del pr
    dk = torch.matmul(ds.to(torch.bfloat16).float().reshape(b, hkv, rows, sk).transpose(-1, -2),
                      q_bf.reshape(b, hkv, rows, d))
    if p.qm is not None:
        colsum = ds.sum(dim=2) * p.scale  # (B, Hq, Sk)
        dk += torch.matmul(colsum.reshape(b, hkv, g, sk).transpose(-1, -2),
                           p.qm.reshape(b, hkv, g, d))
    return dk, dv


def _launch(p: _Prepared, store_dtype: torch.dtype):
    b, hq, hkv, sq, sk, d = p.shape
    dev = p.q.device
    tensors = (p.q, p.k, p.v, p.q_scales, p.k_scales, p.v_scales, p.do, p.lse, p.delta) + tuple(
        t for t in (p.qm, p.vm, p.corr, p.bias) if t is not None)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"quant_bwd kernels need every operand on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    refuse_wide("the quant_bwd kernels", d)
    return (_launch_dq(p, store_dtype), *_launch_dkv(p, store_dtype))


def _launch_dq(p: _Prepared, store_dtype: torch.dtype) -> torch.Tensor:
    b, hq, hkv, sq, sk, d = p.shape
    dq = torch.empty((b, hq, sq, d), dtype=store_dtype, device=p.q.device)
    if dq.numel() and sk:
        _run("quant_bwd_dq", p, dq, None)
    else:
        dq.zero_()
    return dq


def _launch_dkv(p: _Prepared, store_dtype: torch.dtype):
    b, hq, hkv, sq, sk, d = p.shape
    dk = torch.empty((b, hkv, sk, d), dtype=store_dtype, device=p.q.device)
    dv = torch.empty_like(dk)
    if dk.numel() and sq:
        _run("quant_bwd_dkv", p, dk, dv)
    else:
        dk.zero_()
        dv.zero_()
    return dk, dv


def _run(kernel: str, p: _Prepared, out0: torch.Tensor, out1) -> None:
    b, hq, hkv, sq, sk, d = p.shape
    bsb, bsh, bsq, bsk = bias_strides(p.bias)
    int4 = int(p.q_int4) | int(p.k_int4) << 1 | int(p.v_int4) << 2

    def ptr(t):
        return None if t is None else t.data_ptr()

    walk = walk_args(p.walk, "fetch_q" if out1 is not None else "fetch_kv", p.q.device)
    fn = _kernels.function("quant_bwd", f"umfa_{kernel}", _ARGTYPES)
    with torch.cuda.device(p.q.device):
        err = fn(
            p.q.data_ptr(), p.k.data_ptr(), p.v.data_ptr(), p.q_scales.data_ptr(),
            p.k_scales.data_ptr(), p.v_scales.data_ptr(), p.do.data_ptr(), p.lse.data_ptr(),
            p.delta.data_ptr(), ptr(p.qm), ptr(p.vm), ptr(p.corr), ptr(p.bias),
            out0.data_ptr(), ptr(out1),
            b, hq, hkv, sq, sk, d,
            int(p.q_scales.shape[2] > 1), int(p.k_scales.shape[2] > 1),
            int(p.v_scales.shape[2] > 1),
            bsb, bsh, bsq, bsk, p.scale, p.left, p.right, int4,
            _DTYPE_CODE[p.do.dtype], _DTYPE_CODE[out0.dtype], *walk,
            torch.cuda.current_stream(p.q.device).cuda_stream,
        )
    _kernels.check("quant_bwd", err, kernel)
