"""Dense flash-attention forward with LSE (port of umfa_tpu/ops/flash_fwd.py).

`flash_attention_forward` launches a CUDA kernel of `csrc/flash_fwd.cu` on
CUDA tensors (bf16 inputs in bf16, fp32 and fp16 inputs in 3xTF32): the
tensor-core body of `csrc/fwd_tc.cuh` at head_dim <= 256 (one launch), the
wide bodies of `csrc/wide_tc.cuh` above it (two launches: a row-max pass,
then one block per column slice). It runs
`flash_attention_forward_plain`, the same arithmetic in plain PyTorch, on
CPU tensors. There is no fallback between them: a CUDA tensor the kernel
does not take raises (at head_dim > 256: a block-sparse map or RoPE
tables, ROADMAP.md fault 2).

Semantics (the reference's, flash_fwd.py:41-175 and :469-737):
  * causal and window are top-left aligned when Sq != Sk: key j is visible
    to query i iff j <= i + right and j >= i - left (causal: right = 0;
    -1 = unbounded side);
  * index-masked scores are -1e30 and their P is zeroed; a -1e30 bias is
    not an index mask (a row masked by bias alone averages uniformly);
  * a row with no visible key outputs exactly 0 and LSE -1e30;
  * the softmax scale is folded into Q, rounded back to the input type;
    bf16 inputs round P to bf16 before P·V; the row sum adds the rounded P
    at D < 128 (the reference's ones column) and the fp32 P at D >= 128
    (its VPU row sum: no ones column there, flash_fwd.py:499, :523);
  * fp16 is storage-only: computed as fp32 and cast back;
  * a block-sparse map (`block_map`, from a BlockMask, ops/block_mask.py)
    walks key j for query i iff block_map[b, h, i // block_q, j // block_k]
    is not SKIP, the BlockMask's own tiling (flash_fwd.py:340-357: the
    TPU kernel's tiles are the map's); unwalked keys are hidden like
    index-masked ones (P = 0), and the bias is added on the walked keys.
    A row whose walked keys all carry a -1e30 bias averages V over exactly
    those keys. On the card the kernel walks the compacted table
    `fetch_ids` and reads the bias only where a tile is not FULL, so a
    bias given with a map must be 0 on its FULL tiles (a BlockMask's is).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import torch

from umfa_tpu_torch import _kernels
from umfa_tpu_torch.ops.rotary import apply_rope

DEFAULT_MASK_VALUE = -1e30
SKIP = 0  # a tile of a block-sparse map that no row walks (ops/block_mask.py)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The block-sparse walk's trailing arguments: map, compacted table, block_q,
# block_k, nq, nk, the table's width, and the element strides of the map's
# and the table's batch and head (0 = broadcast).
WALK_ARGTYPES = (_P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L)
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L,
             ctypes.c_float, _I, _I, _I, _I, *WALK_ARGTYPES, _P, _P, _P, _P)

# The widest head_dim of the D <= 256 instantiations. Above it rows 1-4
# (flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_dbias) run the wide bodies
# (csrc/wide_tc.cuh; dbias's own body walks any depth); every other kernel,
# and the walked and RoPE instantiations, refuse (`refuse_wide`).
WIDE_D = 256


def refuse_wide(kernel: str, d: int) -> None:
    """Raise, before any launch, for a head_dim above WIDE_D in a kernel
    that takes no wider one yet."""
    if d > WIDE_D:
        raise ValueError(f"{kernel} takes head_dim <= {WIDE_D}, got {d} (ROADMAP.md fault 2: "
                         "only the dense flash_fwd, flash_bwd and flash_dbias take wider heads)")


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """The reference's forward tile requests (umfa_tpu/ops/flash_fwd.py:57-75;
    its backward ones have no use here). The port's kernels pick their own
    tiles; a BlockMask's tiling comes from these (ops/block_mask.py), and
    that tiling decides which keys a row walks. A default-constructed
    instance means "auto"."""

    block_q: int = 512
    block_k: int = 2048


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _choose_block(requested: int, seq: int, head_dim: int):
    """The reference's tile choice (flash_fwd.py:91-112): a tile <= the
    request, clamped to the 128-rounded sequence and to its per-operand cap
    of 2**18 elements, preferring a 128-multiple with <= ~7 % padding."""
    cap = min(requested, _round_up(max(seq, 1), 128))
    while cap > 128 and cap * head_dim > 2**18:
        cap //= 2
    if seq <= cap:
        return cap
    best = cap
    b = cap
    while b >= 256:
        waste = (_round_up(seq, b) - seq) / seq
        if waste <= 0.07:
            return b
        b -= 128
        if b < cap // 2:
            break
    return best


class Walk(NamedTuple):
    """A block-sparse map and its compacted tables (a BlockMask's fields,
    ops/block_mask.py): tile (i, j) of block_q query rows and block_k keys is
    walked iff block_map[.., i, j] != SKIP. fetch_kv (Bm, Hm, nq, w) lists
    each query tile's walked key tiles in order, fetch_q (Bm, Hm, nk, w')
    each key tile's walked query tiles; -1 and below pad a row. hold_kv and
    fill_kv are the reference's fill schedule, kv_mean_tile (Bm, Hm) the key
    tile of each slice's first fill (-1: none), which the single-launch
    quantized route reads (ops/quant_fused_attn.py)."""

    block_map: torch.Tensor
    fetch_kv: Optional[torch.Tensor]
    fetch_q: Optional[torch.Tensor]
    block_q: int
    block_k: int
    hold_kv: Optional[torch.Tensor] = None
    fill_kv: Optional[torch.Tensor] = None
    kv_mean_tile: Optional[torch.Tensor] = None


def make_walk(block_map, fetch_kv, fetch_q, block_q, block_k) -> Optional[Walk]:
    """The public block-sparse keyword arguments as a Walk; None without a map."""
    if block_map is None:
        if fetch_kv is not None or fetch_q is not None:
            raise ValueError("fetch tables need their block_map")
        return None
    if block_q is None or block_k is None or block_q < 1 or block_k < 1:
        raise ValueError("a block_map needs its block_q and block_k")
    return Walk(block_map, fetch_kv, fetch_q, int(block_q), int(block_k))


def _check_walk(walk: Walk, b: int, h: int, sq: int, sk: int) -> None:
    """Refuse a map (and tables) that do not fit (B, H, Sq, Sk)."""
    block_map, fetch_kv, fetch_q = walk.block_map, walk.fetch_kv, walk.fetch_q
    nq, nk = -(-sq // walk.block_q), -(-sk // walk.block_k)
    shape = tuple(block_map.shape)
    if (len(shape) != 4 or shape[0] not in (1, b) or shape[1] not in (1, h)
            or shape[2:] != (nq, nk)):
        raise ValueError(f"block_map shape {shape} does not fit (B {b}|1, H {h}|1, {nq}, {nk})")
    for name, t, n in (("fetch_kv", fetch_kv, nq), ("fetch_q", fetch_q, nk)):
        if t is not None and (t.dim() != 4 or tuple(t.shape[:3]) != shape[:2] + (n,)):
            raise ValueError(f"{name} shape {tuple(t.shape)} does not fit {shape[:2] + (n,)}")


def walked_keys(walk: Walk, sq: int, sk: int) -> torch.Tensor:
    """(Bm, Hm, Sq, Sk) bool: the keys each query row walks."""
    m = walk.block_map != SKIP
    return m.repeat_interleave(walk.block_q, 2)[:, :, :sq].repeat_interleave(
        walk.block_k, 3)[..., :sk]


def walk_args(walk: Optional[Walk], table: str, device) -> tuple:
    """The kernels' trailing walk arguments (WALK_ARGTYPES) for the
    compacted table `table` ("fetch_kv" or "fetch_q") and operands on
    `device`; null without a walk."""
    if walk is None:
        return (None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    m, f = walk.block_map, getattr(walk, table)
    if f is None:
        raise ValueError(f"the block-sparse kernels walk the compacted table {table}: pass it")
    for name, t in (("block_map", m), (table, f)):
        if t.device != device:
            raise ValueError(f"the block-sparse {name} lies on {t.device}, the operands on "
                             f"{device}: build the BlockMask there (device=) or move it (.to)")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")
    bm, hm, nq, nk = m.shape
    w = f.shape[3]
    n_own = f.shape[2]
    return (m.data_ptr(), f.data_ptr(), walk.block_q, walk.block_k, nq, nk, w,
            hm * nq * nk if bm > 1 else 0, nq * nk if hm > 1 else 0,
            hm * n_own * w if bm > 1 else 0, n_own * w if hm > 1 else 0)



def check_no_grad(name: str, *tensors, hint: str) -> None:
    """Refuse tensors that require grad while grad mode is on: the kernel
    wrappers build no autograd graph, so their results would carry no
    gradient on the card (and a plain-PyTorch one on the CPU). `hint` says
    where gradients come from."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} builds no autograd graph: {hint}")


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
    walk: Optional[Walk] = None
    rope: Optional[tuple] = None  # (cos, sin): fp32, contiguous, (S_tab, D/2)


def _prepare(q, k, v, bias, causal, window, scale, out_dtype,
             walk: Optional[Walk] = None, rope: Optional[tuple] = None) -> _Prepared:
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
    if walk is not None:
        _check_walk(walk, b, hq, sq, sk)
    if rope is not None:
        rope = _check_rope(rope, d, max(sq, sk), walk)
    return _Prepared(q, k, v, bias, float(d**-0.5 if scale is None else scale),
                     left, right, out_dtype, fp16_out, walk, rope)


def make_rope(rope_cos, rope_sin) -> Optional[tuple]:
    """The public RoPE keyword arguments as a (cos, sin) pair; None without."""
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin come together")
    return None if rope_cos is None else (rope_cos, rope_sin)


def _check_rope(rope: tuple, d: int, rows: int, walk: Optional[Walk]) -> tuple:
    """Refuse angle tables that do not fit (rows, D/2) or a walk beside them;
    return them as contiguous fp32."""
    cos, sin = rope
    if walk is not None:
        raise ValueError("in-kernel RoPE does not combine with a block-sparse walk: "
                         "rope_attention sends a block_mask to its two-pass route")
    if d % 2:
        raise ValueError(f"in-kernel RoPE needs an even head_dim, got {d}")
    for name, t in (("rope_cos", cos), ("rope_sin", sin)):
        if t.dim() != 2 or t.shape[0] < rows or t.shape[1] != d // 2:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not fit (>= {rows}, {d // 2})")
    return cos.float().contiguous(), sin.float().contiguous()


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
    block_map: Optional[torch.Tensor] = None,
    fetch_ids: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
):
    """Flash attention forward. q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D)
    with Hq % Hkv == 0 (GQA); bias: additive, broadcastable to
    (B, Hq, Sq, Sk) (2-D = (Sq|1, Sk), 3-D = (B, Sq|1, Sk)). block_map
    (Bm, Hm, ceil(Sq / block_q), ceil(Sk / block_k)) int32 and fetch_ids,
    its compacted key-tile table (a BlockMask's fetch_kv), restrict each
    row to the keys of its walked tiles (the module docstring).
    rope_cos/rope_sin: (S >= max(Sq, Sk), D/2) angle tables; Q and K are
    rotated (rotate-half) inside the kernel (the module docstring).

    Returns (out (B, Hq, Sq, D) in out_dtype (default q.dtype),
    lse (B, Hq, Sq) float32). On CUDA tensors one `flash_fwd` launch, two
    at head_dim > 256 (the row-max pass, then the column slices)."""
    return _forward(q, k, v, bias, causal, window, scale, out_dtype,
                    make_walk(block_map, fetch_ids, None, block_q, block_k),
                    make_rope(rope_cos, rope_sin))


def _forward(q, k, v, bias, causal, window, scale, out_dtype, walk: Optional[Walk],
             rope: Optional[tuple] = None):
    """`flash_attention_forward` with its block-sparse arguments as a Walk
    and its angle tables as a (cos, sin) pair."""
    check_no_grad("flash_attention_forward", q, k, v, bias,
                  hint="call ops.attention.flash_attention for gradients")
    p = _prepare(q, k, v, bias, causal, window, scale, out_dtype, walk, rope)
    if p.q.device.type == "cpu":
        out, lse = _plain(p)
    else:
        out, lse = _launch(p)
    return (out.half() if p.fp16_out else out), lse


def flash_attention_forward_plain(
    q, k, v, bias=None, *, causal=False, window=None, scale=None, out_dtype=None,
    block_map=None, fetch_ids=None, block_q=None, block_k=None, rope_cos=None, rope_sin=None,
):
    """The kernel's arithmetic in plain PyTorch, on any device. Same
    arguments and results as `flash_attention_forward`."""
    p = _prepare(q, k, v, bias, causal, window, scale, out_dtype,
                 make_walk(block_map, fetch_ids, None, block_q, block_k),
                 make_rope(rope_cos, rope_sin))
    out, lse = _plain(p)
    return (out.half() if p.fp16_out else out), lse


def _plain(p: _Prepared):
    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    g = hq // hkv
    qf, kf = p.q.float(), p.k.float()
    if p.rope is not None:
        # Q rotated and scaled in fp32, rounded once; K rounded to its type.
        cos, sin = p.rope
        qf = apply_rope(qf, cos[:sq], sin[:sq], interleaved=False)
        kf = apply_rope(kf, cos[:sk], sin[:sk], interleaved=False).to(p.k.dtype).float()
    qs = (qf * p.scale).to(p.q.dtype).float()
    # GQA: fold the group into the query rows (h = hk * g + gi).
    s = torch.matmul(qs.reshape(b, hkv, g * sq, d), kf.transpose(-1, -2))
    s = s.reshape(b, hq, sq, sk)
    if p.bias is not None:
        s += p.bias
    hidden = ~visible_mask(sq, sk, p.left, p.right, s.device)
    if p.walk is not None:
        hidden = hidden | ~walked_keys(p.walk, sq, sk)
    s.masked_fill_(hidden, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True).clamp_min(DEFAULT_MASK_VALUE)
    s.sub_(m).exp_().masked_fill_(hidden, 0.0)
    pr = s.to(p.q.dtype)  # P rounded to the input type before P·V
    l = (pr if d < 128 else s).sum(dim=-1, dtype=torch.float32)
    del s
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
    if p.rope is not None:
        refuse_wide("the ROPE instantiation of flash_fwd", d)
    if p.walk is not None:
        refuse_wide("the block-sparse walk of flash_fwd", d)
    if p.rope is not None and any(t.device != q.device for t in p.rope):
        raise ValueError(f"the RoPE tables lie on {p.rope[0].device}, q on {q.device}")
    walk = walk_args(p.walk, "fetch_kv", q.device)
    out = torch.empty((b, hq, sq, d), dtype=p.out_dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    # The wide forward's row max, between its two launches.
    scratch = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if d > WIDE_D else None
    fn = _kernels.function("flash_fwd", "umfa_flash_fwd", _ARGTYPES)
    bsb, bsh, bsq, bsk = bias_strides(p.bias)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if p.bias is None else p.bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, hq, hkv, sq, sk, d, bsb, bsh, bsq, bsk,
            p.scale, p.left, p.right,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[p.out_dtype], *walk,
            *((None, None) if p.rope is None else (p.rope[0].data_ptr(), p.rope[1].data_ptr())),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _kernels.check("flash_fwd", err, n=2 if d > WIDE_D else 1)
    if p.rope is not None:  # the ROPE instantiation: also counted on its own
        _kernels.launches["flash_fwd/rope"] += 1
    return out, lse
