"""Time the attention forwards of a source tree on the card.

    python umfa_tpu_torch/utils/fwd_timing.py [--tree DIR] [--label NAME] (--fp32 | --ring | --bf16 | --rope | --bias | --wide)

Imports `umfa_tpu_torch` from DIR (default: the tree this file is in), so
another tree, such as a parent commit unpacked with `git archive`, can be
timed beside this one: run parent, change, change, parent, each in its own
process, one after another on the same card (each tree builds its kernels
into its own `_build/`). Median, min and max of 10 CUDA-event timings after
2 warm-up calls.

--fp32: `flash_fwd` on fp32 inputs at the serving prefill (B8 Hq16 Hkv8,
4032 causal queries against 4096 keys, seeded normals) at D 64, 128, 192
and 256, each with its relerr and worst LSE error against the plain version,
its flop and 3xTF32 floor, beside the memory-efficient SDPA forward on the
same inputs (K and V expanded to the query heads outside the timing where
this torch refuses enable_gqa).

--ring: `ring_fwd_step` on one rank's step of the full-width ring (B8 Hq16
Hkv8, S_loc 1024 of S 4096 over 4 ranks; rank 3 against chunk 2, every
pair visible; rank 3's diagonal step; zigzag rank 3 against chunk 1 and
rank 1 against chunk 3, half of the pairs each) at D 64, 128 and 256, bf16
and fp32, each with its relerr against the plain version, its flop and
bound; then the whole ring forward (contiguous and zigzag causal, D 64,
bf16 and fp32, and D 256 fp32) over LocalRing(4). A head dim a tree's
kernel refuses is printed as refused.

--bf16: the unmasked bf16 `flash_fwd` at the training shape (B8 Hq16 Hkv8,
causal S 4096, seeded normals) at D 64 and 128, each with its relerr
against the plain version.

--rope: `flash_fwd` with RoPE tables (the ROPE instantiation, Q and K
rotated inside the kernel) at rope_attention's geometries (ROPE_SHAPES,
which `chip_smoke.py` also drives), each with its relerr against the plain
version, beside the same kernel without tables on the same inputs (the
rotation's cost); `chip_smoke.py` times the two-pass route and SDPA.

--bias: the bf16 `flash_fwd` on the MLA indexer's call (B8 H16 S4096 D64
causal, `chip_smoke.py` phase 14c) with a seeded top-128 bias of shape
(8, 1, 4096, 4096) fp32 (each row keeps the 128 keys of highest seeded
uniform score: 0 there, -1e30 elsewhere), with its relerr, worst LSE error
and the count of visible rows past 1e-3 against the plain version (each
such row, up to 32, read against the float64 LSE of the plain version's
rounding points: `utils/testing.lse_check`), its
flop (4·D a visible pair) and bound (q, k, v, out, LSE and the bias once);
then the same call without the bias.

--wide: `flash_fwd` at head dims above 256 (the wide body, two launches a
call) at `chip_smoke.py` phase 19's shapes (WIDE_SHAPE, the FLUX VAE
mid-block B1 H1 S16384 D512 non-causal, and the widest of WIDE_GQA, B1 Hq4
Hkv2 S1024 D1024 causal; this file's, whatever --tree), bf16 and fp32, each with its relerr and worst LSE
error against the plain version and each kernel's device ms by
torch.profiler (the row-max pass and the column slices); then the fp32
highest-accuracy case of tests/test_torch_kernels_cuda.py (B2 H4 S1024
causal, q ~ N(0, 3), its inputs from seeds 0-3, seed 0 the test's) at D 256
and 512: the rows whose LSE is past 1e-5 from the plain version's, and
both sides' distance from the float64 LSE and out of the same rounding
points (`utils/testing.lse_f64`'s arithmetic on every row). Phase 19 times
the wide backward.

Prints one JSON line per timing, then the card's name and power limit as
nvidia-smi gives them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

B, HQ, HKV, SQ, SK = 8, 16, 8, 4032, 4096
H100_BF16_FLOPS, H100_TF32_FLOPS, H100_HBM_BYTES = 989e12, 495e12, 3.35e12
RING_N, RING_S_LOC = 4, 1024
# name: (my, src, zigzag); all causal.
RING_STEPS = {"full": (3, 2, False), "diagonal": (3, 3, False),
              "zigzag_first_half_of_keys": (3, 1, True), "zigzag_second_half_of_rows": (1, 3, True)}


def _bound_ms(flops, nbytes, fp32):
    """The larger of the operation time (fp32: three TF32 products for each
    fp32 one, the 3xTF32 floor) and the byte time, in ms."""
    ops = 3 * flops / H100_TF32_FLOPS if fp32 else flops / H100_BF16_FLOPS
    return max(ops, nbytes / H100_HBM_BYTES) * 1e3


def _time_fp32(emit, stats):
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward, flash_attention_forward_plain
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    pairs = B * HQ * sum(min(i + 1, SK) for i in range(SQ))
    for d in (64, 128, 192, 256):
        q, k, v = (torch.randn(s, generator=gen).to(dev) for s in
                   ((B, HQ, SQ, d), (B, HKV, SK, d), (B, HKV, SK, d)))

        def run(q=q, k=k, v=v):
            return flash_attention_forward(q, k, v, causal=True)

        got = run()
        want = flash_attention_forward_plain(q, k, v, causal=True)
        err = dict(relerr_out=rel_err(got[0], want[0]),
                   max_abs_lse=float((got[1] - want[1]).abs().max()))
        del got, want
        torch.cuda.empty_cache()
        flops = 4 * d * pairs
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * HQ * SQ
        st = stats(run)
        emit(kernel="flash_fwd", dtype="float32", D=d, **st, **err, flops=flops,
             tflops=flops / st["ms"] / 1e9, bound_ms=_bound_ms(flops, nbytes, True))
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                F.scaled_dot_product_attention(q[:1, :, :64], k[:1, :, :64], v[:1, :, :64],
                                               is_causal=True, enable_gqa=True)
            kl, vl, gqa, how = k, v, dict(enable_gqa=True), "enable_gqa"
        except (RuntimeError, TypeError):
            kl, vl, gqa = k.repeat_interleave(HQ // HKV, 1), v.repeat_interleave(HQ // HKV, 1), {}
            how = "K and V expanded to the query heads"

        def sdpa(q=q, kl=kl, vl=vl, gqa=gqa):
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(q, kl, vl, is_causal=True, **gqa)

        emit(kernel="sdpa_efficient_forward", dtype="float32", D=d, gqa=how, **stats(sdpa))
        del q, k, v, kl, vl
        torch.cuda.empty_cache()


def _time_ring(emit, stats):
    import torch

    from umfa_tpu_torch.parallel import LocalRing
    from umfa_tpu_torch.parallel import ring_pallas as rp
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    s_loc, n = RING_S_LOC, RING_N
    for dtype in (torch.bfloat16, torch.float32):
        fp32 = dtype == torch.float32
        for d in (64, 128, 256):
            scale = d**-0.5
            q = torch.randn((B, HQ, s_loc, d), generator=gen).to(dev, dtype)
            k, v = (torch.randn((B, HKV, s_loc, d), generator=gen).to(dev, dtype)
                    for _ in range(2))
            o = torch.randn(q.shape, generator=gen).to(dev, dtype)
            lse = torch.randn((B, HQ, s_loc), generator=gen).to(dev)
            for step, (my, src, zigzag) in RING_STEPS.items():
                c = rp._Step(n, my, src, False, True, zigzag, scale, s_loc // 2 if zigzag else s_loc)
                pairs = B * HQ * int(c.keep(s_loc, dev).sum())
                start = (o.clone(), lse.clone())
                try:
                    rp.ring_fwd_step(q, k, v, o, lse, c)
                except ValueError as e:
                    emit(kernel="ring_fwd_step", dtype=str(dtype)[6:], step=step, D=d,
                         refused=str(e))
                    continue
                got = (o.clone(), lse.clone())
                o.copy_(start[0])
                lse.copy_(start[1])
                rp._fwd_step_plain(q, k, v, o, lse, c)
                err = dict(relerr_out=rel_err(got[0], o),
                           max_abs_lse=float((got[1] - lse).abs().max()))
                flops = 4 * d * pairs
                esize = q.element_size()
                # q, k, v read; o and lse read and written.
                nbytes = esize * (q.numel() + k.numel() + v.numel() + 2 * o.numel()) + 8 * lse.numel()
                st = stats(lambda c=c: rp.ring_fwd_step(q, k, v, o, lse, c))
                o.copy_(start[0])
                lse.copy_(start[1])
                emit(kernel="ring_fwd_step", dtype=str(dtype)[6:], step=step, D=d, **st, **err,
                     flops=flops, tflops=flops / st["ms"] / 1e9,
                     bound_ms=_bound_ms(flops, nbytes, fp32))
                del start, got
            del q, k, v, o, lse
            torch.cuda.empty_cache()

    s = n * s_loc
    for dtype, d in ((torch.bfloat16, 64), (torch.float32, 64), (torch.float32, 256)):
        q = torch.randn((B, HQ, s, d), generator=gen).to(dev, dtype)
        k, v = (torch.randn((B, HKV, s, d), generator=gen).to(dev, dtype) for _ in range(2))
        for layout, zigzag in (("causal", False), ("zigzag", True)):
            cfg = rp._config(s_loc, True, zigzag, d**-0.5, None)
            run = lambda cfg=cfg: rp._ring_fwd(q, k, v, LocalRing(n), cfg)  # noqa: E731
            try:
                run()
            except ValueError as e:
                emit(kernel="ring_forward", dtype=str(dtype)[6:], layout=layout, D=d,
                     refused=str(e))
                continue
            emit(kernel="ring_forward", dtype=str(dtype)[6:], layout=layout, D=d,
                 **stats(run, iters=5))
        del q, k, v
        torch.cuda.empty_cache()


def _time_bf16(emit, stats):
    import torch

    from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward, flash_attention_forward_plain
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    s = SK
    for d in (64, 128):
        q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16) for shape in
                   ((B, HQ, s, d), (B, HKV, s, d), (B, HKV, s, d)))

        def run(q=q, k=k, v=v):
            return flash_attention_forward(q, k, v, causal=True)

        err = rel_err(run()[0], flash_attention_forward_plain(q, k, v, causal=True)[0])
        torch.cuda.empty_cache()
        emit(kernel="flash_fwd", dtype="bfloat16", shape=f"B{B} Hq{HQ} Hkv{HKV} S{s} causal",
             D=d, relerr=err, **stats(run))
        del q, k, v
        torch.cuda.empty_cache()


# rope_attention's geometries (scripts/rope_ab.py:17-18): FLUX, B1 H24
# S4608 D128 non-causal; S4K, B2 H16 S4096 D64 causal; bf16, and the S4K
# geometry once in fp32. (name, B, H, S, D, causal, dtype)
ROPE_SHAPES = (("flux", 1, 24, 4608, 128, False, "bfloat16"),
               ("s4k", 2, 16, 4096, 64, True, "bfloat16"),
               ("s4k_fp32", 2, 16, 4096, 64, True, "float32"))


def _time_rope(emit, stats):
    import torch

    from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward, flash_attention_forward_plain
    from umfa_tpu_torch.ops.rope import rope_angles
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for name, b, h, s, d, causal, dt in ROPE_SHAPES:
        q, k, v = (torch.randn((b, h, s, d), generator=gen).to(dev, getattr(torch, dt))
                   for _ in range(3))
        cos, sin = rope_angles(s, d, device=dev)

        def rope(q=q, k=k, v=v):
            return flash_attention_forward(q, k, v, causal=causal, rope_cos=cos, rope_sin=sin)

        def dense(q=q, k=k, v=v):
            return flash_attention_forward(q, k, v, causal=causal)

        err = rel_err(rope()[0], flash_attention_forward_plain(
            q, k, v, causal=causal, rope_cos=cos, rope_sin=sin)[0])
        torch.cuda.empty_cache()
        emit(kernel="flash_fwd/rope", case=name, dtype=dt, relerr=err,
             shape=f"B{b} H{h} S{s} D{d} {'causal' if causal else 'non-causal'}", **stats(rope),
             dense_ms=stats(dense)["ms"])
        del q, k, v
        torch.cuda.empty_cache()


def _time_bias(emit, stats):
    import torch

    from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward, flash_attention_forward_plain
    from umfa_tpu_torch.utils.testing import lse_check, rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    b, h, s, d, topk = 8, 16, 4096, 64, 128
    q, k, v = (torch.randn((b, h, s, d), generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    scores = torch.rand((b, s, s), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    kth = torch.topk(scores, topk, dim=-1).values[..., -1:]
    bias = torch.where(scores >= kth, 0.0, -1e30)[:, None]
    del scores, kth
    pairs = b * h * s * (s + 1) // 2
    for label, bb in (("bias", bias), ("none", None)):
        def run(bb=bb):
            return flash_attention_forward(q, k, v, bb, causal=True)

        got = run()
        want = [flash_attention_forward_plain(q[i:i + 2], k[i:i + 2], v[i:i + 2],
                                              None if bb is None else bb[i:i + 2], causal=True)
                for i in range(0, b, 2)]
        want = tuple(torch.cat(parts) for parts in zip(*want))
        causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
        err = dict(relerr_out=rel_err(got[0], want[0]),
                   **lse_check(got[1], want[1], q, k, bb, 1e-3, keep=causal))
        del got, want
        torch.cuda.empty_cache()
        flops = 4 * d * pairs
        nbytes = 2 * 4 * q.numel() + 4 * b * h * s + (  # q, k, v, out; LSE; the bias
            0 if bb is None else bb.numel() * 4)
        st = stats(run, iters=10)
        emit(kernel="flash_fwd", case=f"mla_indexer_{label}", dtype="bfloat16",
             shape=f"B{b} H{h} S{s} D{d} causal" + ("" if bb is None else
                                                   f", bias {tuple(bb.shape)} fp32 top-{topk}"),
             **st, **err, flops=flops, tflops=flops / st["ms"] / 1e9,
             bound_ms=_bound_ms(flops, nbytes, False))
    del q, k, v, bias
    torch.cuda.empty_cache()

# Head dims above 256 (`chip_smoke.py` phase 19 and --wide). The FLUX VAE
# decoder's mid-block attention: one head as wide as its 512 channels over
# the 128 x 128 latent of a 1024 x 1024 image (diffusers `Decoder`,
# src/diffusers/models/autoencoders/vae.py: UNetMidBlock2D(
# attention_head_dim=block_out_channels[-1]), block_out_channels
# [128, 256, 512, 512]), non-causal, through F.scaled_dot_product_attention.
WIDE_SHAPE = (1, 1, 16384, 512)  # B, H, S, D
WIDE_BIAS_SHAPE = (1, 2, 2048, 512)  # the bias_grad case, a (1, H, S, S) fp32 bias
WIDE_GQA = ((300, 1024), 1, 4, 2, 1024)  # head dims; B, Hq, Hkv, S, causal


def _kernels_ms(fn, reps=3):
    """Each CUDA kernel's device ms a call of fn(), by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / reps / 1e3 for e in prof.key_averages()
            if e.device_time_total > 0}


def _f64(q, k, v, causal):
    """The plain forward's out and LSE with its rounding points (Q·scale
    rounded to q's dtype; P kept unrounded, as at D >= 128) and every sum
    in float64; Hq == Hkv."""
    import torch

    qs = (q.float() * q.shape[-1] ** -0.5).to(q.dtype).double()
    s = qs @ k.double().transpose(-1, -2)
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.exp(s - lse[..., None]) @ v.double(), lse


def _time_wide(emit, stats):
    import torch

    from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward, flash_attention_forward_plain
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    b, h, s, d = WIDE_SHAPE
    dims, gb, ghq, ghkv, gs = WIDE_GQA
    shapes = {"vae_mid_block": (b, h, h, s, d, False),
              f"causal_gqa_d{max(dims)}": (gb, ghq, ghkv, gs, max(dims), True)}
    for name, (b, hq, hkv, s, d, causal) in shapes.items():
        for dt in ("bfloat16", "float32"):
            q, k, v = (torch.randn(shape, generator=gen).to(dev, getattr(torch, dt))
                       for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))

            def run(q=q, k=k, v=v):
                return flash_attention_forward(q, k, v, causal=causal)

            out, lse = run()
            want, want_lse = flash_attention_forward_plain(q, k, v, causal=causal)
            err = dict(relerr=rel_err(out, want),
                       max_abs_lse=float((lse - want_lse).abs().max()))
            del out, lse, want, want_lse
            torch.cuda.empty_cache()
            emit(kernel="flash_fwd", case=name, dtype=dt, **err,
                 shape=f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} {'causal' if causal else 'non-causal'}",
                 **stats(run), kernels_ms=_kernels_ms(run))
            del q, k, v
            torch.cuda.empty_cache()
    tol = 1e-5
    for d in (256, 512):
        for seed in range(4):
            g = torch.Generator().manual_seed(seed)
            q, k, v = (torch.randn((2, 4, 1024, d), generator=g) for _ in range(3))
            q, k, v = (q * 3.0).to(dev), k.to(dev), v.to(dev)
            out, lse = flash_attention_forward(q, k, v, causal=True)
            want, want_lse = flash_attention_forward_plain(q, k, v, causal=True)
            o64, l64 = _f64(q, k, v, True)
            kern, plain = (lse.double() - l64).abs(), (want_lse.double() - l64).abs()
            emit(kernel="flash_fwd", case="fp32_highest_accuracy", dtype="float32",
                 shape=f"B2 H4 S1024 D{d} causal, q ~ N(0, 3)", seed=seed,
                 lse_rows_over_tol_vs_plain=int(((lse - want_lse).abs() > tol).sum()),
                 max_abs_lse_vs_plain=float((lse - want_lse).abs().max()),
                 kernel_max_abs_lse_from_f64=float(kern.max()),
                 plain_max_abs_lse_from_f64=float(plain.max()),
                 kernel_lse_rows_over_tol_from_f64=int((kern > tol).sum()),
                 plain_lse_rows_over_tol_from_f64=int((plain > tol).sum()),
                 relerr_out_vs_plain=rel_err(out, want),
                 kernel_relerr_out_from_f64=rel_err(out.double(), o64),
                 plain_relerr_out_from_f64=rel_err(want.double(), o64))
            del q, k, v, out, lse, want, want_lse, o64, l64, kern, plain
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default="tree")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--fp32", action="store_true", help="flash_fwd on fp32 inputs at the prefill")
    mode.add_argument("--ring", action="store_true", help="ring_fwd_step and the whole ring forward")
    mode.add_argument("--bf16", action="store_true", help="the bf16 flash_fwd at the training shape")
    mode.add_argument("--rope", action="store_true", help="flash_fwd with in-kernel RoPE")
    mode.add_argument("--bias", action="store_true",
                      help="flash_fwd on the MLA indexer's call, with and without its bias")
    mode.add_argument("--wide", action="store_true",
                      help="flash_fwd at head dims above 256, and its fp32 LSE from float64")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    if sys.path and os.path.abspath(sys.path[0]) == here:
        sys.path.pop(0)  # run as a script: its own directory would shadow top-level names
    sys.path.insert(0, tree)

    import torch

    from umfa_tpu_torch import _kernels

    if not torch.cuda.is_available():
        print("fwd_timing: no CUDA device", file=sys.stderr)
        return 2
    if not _kernels.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {_kernels.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build_all(("ring_attn",) if args.ring else ("flash_fwd",))
    from umfa_tpu_torch.utils.bwd_timing import _stats

    def emit(**kw):
        print(json.dumps({"tree": args.label, **kw}), flush=True)

    (_time_ring if args.ring else _time_bf16 if args.bf16 else _time_rope if args.rope
     else _time_bias if args.bias else _time_wide if args.wide else _time_fp32)(emit, _stats)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
