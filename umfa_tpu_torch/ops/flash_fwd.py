"""Dense flash-attention forward with LSE (port of umfa_tpu/ops/flash_fwd.py).

`flash_attention_forward` launches the CUDA kernel `csrc/flash_fwd.cu` on
CUDA tensors and runs `flash_attention_forward_plain`, the same arithmetic
in plain PyTorch, on CPU tensors. There is no fallback between the two: a
CUDA tensor the kernel does not take raises.

Semantics (the reference's, flash_fwd.py:41-175 and :469-737):
  * causal and window are top-left aligned when Sq != Sk: key j is visible
    to query i iff j <= i + right and j >= i - left (causal: right = 0;
    -1 = unbounded side);
  * index-masked scores are -1e30 and their P is zeroed; a -1e30 bias is
    not an index mask (a row masked by bias alone averages uniformly);
  * a row with no visible key outputs exactly 0 and LSE -1e30;
  * the softmax scale is folded into Q, rounded back to the input type;
    bf16 inputs round P to bf16 before P·V and sum the rounded P;
  * fp16 is storage-only: computed as fp32 and cast back.
Not ported yet: block-sparse `block_map`/`fetch_ids` and in-kernel RoPE.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from umfa_tpu_torch import _kernels

DEFAULT_MASK_VALUE = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L,
             ctypes.c_float, _I, _I, _I, _I, _P)


def check_no_grad(name: str, *tensors) -> None:
    """Serving needs no gradients; the backward kernels arrive with the
    training slice. Refuse rather than return wrong gradients."""
    if any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward yet (it arrives with the training "
            "slice of the port); pass tensors that do not require grad"
        )


def fold_mask(causal: bool, window) -> tuple:
    """(causal, window) → (left, right) key bounds relative to the query
    row, -1 = unbounded."""
    left = -1
    right = 0 if causal else -1
    if window is not None:
        wl, wr = int(window[0]), int(window[1])
        if wl >= 0:
            left = wl
        if wr >= 0:
            right = wr if right < 0 else min(right, wr)
    return left, right


def visible_mask(sq: int, sk: int, left: int, right: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: key j visible to query i (top-left aligned)."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if left >= 0:
        vis &= kj >= qi - left
    if right >= 0:
        vis &= kj <= qi + right
    return vis


def broadcast_bias(bias: torch.Tensor, b: int, h: int, sq: int, sk: int) -> torch.Tensor:
    """Validate a 4-D additive bias against (B, H, Sq, Sk) and return it as
    an fp32 view expanded to that shape (broadcast dims keep stride 0)."""
    if bias.dim() != 4:
        raise ValueError(f"bias must be 4-D here, got shape {tuple(bias.shape)}")
    for got, full in zip(bias.shape, (b, h, sq, sk)):
        if got not in (1, full):
            raise ValueError(
                f"bias shape {tuple(bias.shape)} does not broadcast to "
                f"{(b, h, sq, sk)}"
            )
    if bias.shape[3] != sk:
        raise ValueError(f"bias last dim {bias.shape[3]} != Sk {sk}")
    return bias.float().expand(b, h, sq, sk)


def bias_strides(bias4: Optional[torch.Tensor]) -> tuple:
    """Element strides of an expanded bias, 0 for broadcast dimensions."""
    if bias4 is None:
        return (0, 0, 0, 0)
    return tuple(st if n > 1 else 0 for st, n in zip(bias4.stride(), bias4.shape))


class _Prepared(NamedTuple):
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    bias: Optional[torch.Tensor]
    scale: float
    left: int
    right: int
    out_dtype: torch.dtype
    fp16_out: bool


def _prepare(q, k, v, bias, causal, window, scale, out_dtype) -> _Prepared:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads {hq} must be a multiple of kv heads {hkv}")
    fp16_out = (out_dtype is None and q.dtype == torch.float16) or out_dtype == torch.float16
    # fp16 is storage-only (reference: flash_fwd.py:808-819).
    if q.dtype == torch.float16:
        q = q.float()
    if k.dtype == torch.float16:
        k, v = k.float(), v.float()
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes q={q.dtype} k={k.dtype} v={v.dtype}")
    if fp16_out:
        out_dtype = torch.float32
    if out_dtype is None:
        out_dtype = q.dtype
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    if bias is not None:
        if bias.dim() == 2:
            bias = bias[None, None]
        elif bias.dim() == 3:
            bias = bias[:, None]
        bias = broadcast_bias(bias, b, hq, sq, sk)
    left, right = fold_mask(causal, window)
    return _Prepared(q, k, v, bias, float(d**-0.5 if scale is None else scale),
                     left, right, out_dtype, fp16_out)


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: Optional[tuple] = None,
    scale: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
):
    """Flash attention forward. q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D)
    with Hq % Hkv == 0 (GQA); bias: additive, broadcastable to
    (B, Hq, Sq, Sk) (2-D = (Sq|1, Sk), 3-D = (B, Sq|1, Sk)).

    Returns (out (B, Hq, Sq, D) in out_dtype (default q.dtype),
    lse (B, Hq, Sq) float32)."""
    check_no_grad("flash_attention_forward", q, k, v, bias)
    p = _prepare(q, k, v, bias, causal, window, scale, out_dtype)
    if p.q.device.type == "cpu":
        out, lse = _plain(p)
    else:
        out, lse = _launch(p)
    return (out.half() if p.fp16_out else out), lse


def flash_attention_forward_plain(
    q, k, v, bias=None, *, causal=False, window=None, scale=None, out_dtype=None,
):
    """The kernel's arithmetic in plain PyTorch, on any device. Same
    arguments and results as `flash_attention_forward`."""
    p = _prepare(q, k, v, bias, causal, window, scale, out_dtype)
    out, lse = _plain(p)
    return (out.half() if p.fp16_out else out), lse


def _plain(p: _Prepared):
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
    s.masked_fill_(hidden, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True).clamp_min(DEFAULT_MASK_VALUE)
    s.sub_(m).exp_().masked_fill_(hidden, 0.0)
    pr = s.to(p.q.dtype)  # P rounded to the input type before P·V
    del s
    l = pr.sum(dim=-1, dtype=torch.float32)
    pv = torch.matmul(pr.float().reshape(b, hkv, g * sq, sk), p.v.float())
    pv = pv.reshape(b, hq, sq, d)
    empty = l == 0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    out = (pv / l_safe[..., None]).to(p.out_dtype)
    lse = torch.where(empty, torch.full_like(l, DEFAULT_MASK_VALUE),
                      m[..., 0] + torch.log(l_safe))
    return out, lse


def _launch(p: _Prepared):
    q, k, v = p.q, p.k, p.v
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_fwd kernel needs q, k, v on one CUDA device, got {q.device}/{k.device}/{v.device}")
    if p.bias is not None and p.bias.device != q.device:
        raise ValueError(f"bias on {p.bias.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd kernel needs a contiguous {name}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if d > 128:
        raise ValueError(f"flash_fwd kernel takes head_dim <= 128, got {d}")
    out = torch.empty((b, hq, sq, d), dtype=p.out_dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _kernels.function("flash_fwd", "umfa_flash_fwd", _ARGTYPES)
    bsb, bsh, bsq, bsk = bias_strides(p.bias)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if p.bias is None else p.bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, hq, hkv, sq, sk, d, bsb, bsh, bsq, bsk,
            p.scale, p.left, p.right,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[p.out_dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _kernels.check("flash_fwd", err)
    return out, lse
