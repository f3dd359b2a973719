"""Flash-decode over the INT8 KV cache (port of
umfa_tpu/serving/decode_kernel.py).

`quantized_flash_decode` launches the CUDA kernel of
`csrc/flash_decode.cu` on CUDA tensors and runs
`quantized_flash_decode_plain`, the reference kernel's arithmetic in plain
PyTorch, on CPU tensors. There is no fallback between the two: a CUDA
tensor the kernel does not take raises.

GQA folds the query group into the rows, q → (B, Hkv, g·Tq, D) row-major
(g, t), so each K/V row is read once for the whole group. The plain version
walks the KV axis in `block_k` tiles with a running (m, l, acc), exactly as
`_decode_kernel` does, so it rounds where the TPU kernel rounds:
  * s = q · widen(k8) with fp32 sums, then s · (ks · scale) + bias, with
    ks · scale formed first (the K scale multiplies after the dot);
  * m, l start at -1e30 and 0; α = exp(m_prev - m_new), p = exp(s - m_new),
    l = α·l + Σp, all fp32;
  * pv = cdt(p · vs) · widen(v8): the V scale folds into P BEFORE the
    rounding to cdt (fp32 for fp32 q, else bf16); acc = acc·α + pv;
  * out = acc / l, with l = 0 replaced by 1.
A slot whose every column carries the -1e30 bias (length 0) averages V
uniformly, as the reference does.

This route rounds differently from `serving/decode._gemv_decode`, which
forms (s·ks)·scale and rounds the normalized P·vs: the two agree to ~2e-5
in fp32, not bit for bit.

The CUDA kernel (`csrc/flash_decode.cu`) is one launch: it splits the KV
axis over the eight blocks of a thread-block cluster, each walking its
rows with its own running (m, l, acc), and merges the splits inside the
launch in a fixed order, so two calls on the same inputs give the same
bits. In bf16 it rounds cdt(p · vs) against the running maximum of its own
walk, not the tile walk's, and is held to its plain version by tolerance
(bf16 relerr 1e-2, fp32 2e-5).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from umfa_tpu_torch import _kernels
from umfa_tpu_torch.ops.flash_fwd import refuse_wide

DEFAULT_MASK_VALUE = -1e30

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, ctypes.c_float,
             _I, _P)


class _Prepared(NamedTuple):
    q: torch.Tensor         # (B, Hkv, g·Tq, D), fp32 or bf16
    k: torch.Tensor         # (B, Hkv, S, D) int8
    ks: torch.Tensor        # (B, Hkv, S) fp32
    v: torch.Tensor
    vs: torch.Tensor
    bias: torch.Tensor      # (B, 1, Tq, S) fp32 (broadcast dims may have stride 0)
    scale: float
    block_k: int
    hq: int
    tq: int


def _prepare(q, k_values, k_scales, v_values, v_scales, bias, scale, block_k) -> _Prepared:
    if q.dim() != 4 or k_values.dim() != 4 or v_values.dim() != 4:
        raise ValueError("q must be (B, Hq, Tq, D) and k/v values (B, Hkv, S, D)")
    b, hq, tq, d = q.shape
    _, hkv, s_max, _ = k_values.shape
    if v_values.shape != k_values.shape or k_values.shape[0] != b or k_values.shape[3] != d:
        raise ValueError(f"k/v values {tuple(k_values.shape)}/{tuple(v_values.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k_values.dtype != torch.int8 or v_values.dtype != torch.int8:
        raise ValueError(f"flash decode reads an INT8 cache, got {k_values.dtype}/{v_values.dtype}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads {hq} must be a multiple of kv heads {hkv}")
    for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
        if s.numel() != b * hkv * s_max:
            raise ValueError(f"{name} {tuple(s.shape)} must hold one scale per cache row")
    if bias.dim() != 4 or bias.shape[0] not in (1, b) or bias.shape[1] != 1 \
            or bias.shape[2] not in (1, tq) or bias.shape[3] != s_max:
        raise ValueError(f"bias {tuple(bias.shape)} must be (B, 1, Tq | 1, S_max)")
    block_k = min(int(block_k), s_max)
    if block_k < 1 or s_max % block_k:
        raise ValueError(f"S_max {s_max} must be a multiple of block_k {block_k}")
    group = hq // hkv
    qg = q.reshape(b, hkv, group * tq, d)
    if q.dtype != torch.float32:
        qg = qg.to(torch.bfloat16)
    return _Prepared(
        q=qg, k=k_values, ks=k_scales.float().reshape(b, hkv, s_max),
        v=v_values, vs=v_scales.float().reshape(b, hkv, s_max),
        bias=bias.float().expand(b, 1, tq, s_max),
        scale=float(d**-0.5 if scale is None else scale), block_k=block_k, hq=hq, tq=tq,
    )


def quantized_flash_decode(
    q: torch.Tensor,          # (B, Hq, Tq, D)
    k_values: torch.Tensor,   # (B, Hkv, S, D) int8
    k_scales: torch.Tensor,   # (B, Hkv, S, 1) f32
    v_values: torch.Tensor,
    v_scales: torch.Tensor,
    bias: torch.Tensor,       # (B, 1, Tq, S) or (B, 1, 1, S) f32
    *,
    scale: Optional[float] = None,
    block_k: int = 2048,
) -> torch.Tensor:
    """Flash-decode over a quantized cache; returns (B, Hq, Tq, D) f32."""
    p = _prepare(q, k_values, k_scales, v_values, v_scales, bias, scale, block_k)
    out = _plain(p) if p.q.device.type == "cpu" else _launch(p)
    b, hkv, gtq, d = out.shape
    return out.reshape(b, p.hq, p.tq, d)


def quantized_flash_decode_plain(q, k_values, k_scales, v_values, v_scales, bias, *,
                                 scale=None, block_k=2048):
    """The reference kernel's tile walk in plain PyTorch, on any device.
    Same arguments and results as `quantized_flash_decode`."""
    p = _prepare(q, k_values, k_scales, v_values, v_scales, bias, scale, block_k)
    out = _plain(p)
    b, hkv, gtq, d = out.shape
    return out.reshape(b, p.hq, p.tq, d)


def _plain(p: _Prepared) -> torch.Tensor:
    b, hkv, gtq, d = p.q.shape
    s_max = p.k.shape[2]
    group = gtq // p.tq
    cdt = torch.float32 if p.q.dtype == torch.float32 else torch.bfloat16
    qf = p.q.float()
    # Bias rows are per t; tile them over the g query groups (row-major
    # (g, t), as the host-side q reshape).
    bias = p.bias.repeat(1, 1, group, 1) if group > 1 else p.bias
    m = torch.full((b, hkv, gtq, 1), DEFAULT_MASK_VALUE, dtype=torch.float32, device=qf.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, gtq, d), dtype=torch.float32, device=qf.device)
    for s0 in range(0, s_max, p.block_k):
        tile = slice(s0, s0 + p.block_k)
        # Products of cdt values are exact in fp32; sums in fp32.
        s = torch.matmul(qf, p.k[:, :, tile].to(cdt).float().transpose(-1, -2))
        col_scale = p.ks[:, :, None, tile] * p.scale
        s = s * col_scale + bias[..., tile]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pt = torch.exp(s - m_new)
        l = alpha * l + pt.sum(dim=-1, keepdim=True)
        # The V scale folds into P before the rounding to cdt.
        pv = torch.matmul((pt * p.vs[:, :, None, tile]).to(cdt).float(),
                          p.v[:, :, tile].to(cdt).float())
        m = m_new
        acc = acc * alpha + pv
    return acc / torch.where(l == 0.0, torch.ones_like(l), l)


def _launch(p: _Prepared) -> torch.Tensor:
    """The CUDA kernel: out (B, Hkv, g·Tq, D) f32 in one launch."""
    if p.q.numel() == 0:
        return torch.empty(p.q.shape, dtype=torch.float32, device=p.q.device)
    dev = p.q.device
    tensors = (("q", p.q), ("k_values", p.k), ("k_scales", p.ks), ("v_values", p.v),
               ("v_scales", p.vs), ("bias", p.bias))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"flash_decode kernel needs every operand on one CUDA device, "
                             f"got {name} on {t.device} (q on {dev})")
    b, hkv, gtq, d = p.q.shape
    s_max = p.k.shape[2]
    refuse_wide("the flash_decode kernel", d)
    if p.tq > 16:
        raise ValueError(f"flash_decode kernel takes Tq <= 16 new queries, got {p.tq}")
    q = p.q.contiguous()
    k, v = p.k.contiguous(), p.v.contiguous()
    ks, vs = p.ks.contiguous(), p.vs.contiguous()
    out = torch.empty((b, hkv, gtq, d), dtype=torch.float32, device=dev)
    bsb, _, bst, bss = (st if n > 1 else 0 for st, n in zip(p.bias.stride(), p.bias.shape))
    fn = _kernels.function("flash_decode", "umfa_flash_decode", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(),
                 p.bias.data_ptr(), out.data_ptr(), b, hkv, gtq, p.tq, s_max, d, bsb, bst, bss,
                 p.scale, int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check("flash_decode", err)
    return out
