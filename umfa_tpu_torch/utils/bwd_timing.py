"""Time the backward kernels of a source tree on the card.

    python umfa_tpu_torch/utils/bwd_timing.py [--tree DIR] [--label NAME] [--wide | --fp32 | --ring]

Imports `umfa_tpu_torch` from DIR (default: the tree this file is in), so
another tree, such as a parent commit unpacked with `git archive`, can be
timed beside this one: run parent, change, change, parent, each in its own
process, one after another on the same card (each tree builds its kernels
into its own `_build/`). At the training shape (B8 Hq16 Hkv8 S4096 causal bf16) it
times `flash_bwd_dq`, `flash_bwd_dkv` and `flash_dbias` (a (1, 16, S, S)
bias summed over the batch) at D 64 and 128 (and 256 with --wide), and
`quant_bwd_dq` and `quant_bwd_dkv` on the int8 recipe's residuals at D 64:
median, min and max of 10 CUDA-event timings after 2 warm-up calls, and at
D 64 each dense kernel's relerr against its plain version. With --fp32 it
times only `flash_bwd_dq` and `flash_bwd_dkv` on fp32 inputs (what the
int8-qdense recipe runs) and `flash_dbias` on fp32 inputs (the same
(1, 16, S, S) bias; 5 timings after 1 warm-up) at the training shape, D
64, 128 and 256, each with its relerr against its plain version, beside the memory-efficient SDPA
backward (dQ, dK and dV in one call) on the same fp32 inputs. With
--ring it times only `ring_bwd_dkv` and `ring_bwd_dq` on one rank's step of
the full-width ring (B8 Hq16 Hkv8, S_loc 1024 of S 4096 over 4 ranks; rank
3 against chunk 2, every pair visible; rank 3's diagonal step; zigzag rank
3 against chunk 1 and rank 1 against chunk 3, half of the pairs each), bf16
at D 64 and 128 (and 256 with --wide) and fp32 at D 256, each with its
relerr against its plain version, its flop and bound (fp32: the 3xTF32
floor), then the whole ring backward (contiguous and zigzag causal, bf16 D
64 and fp32 D 256) over LocalRing(4). A head dim a tree's kernels refuse
is printed as refused. Prints one JSON line per timing, then the card's
name and power limit as nvidia-smi gives them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

B, HQ, HKV, S = 8, 16, 8, 4096


def _stats(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return {"ms": statistics.median(times), "ms_min": min(times), "ms_max": max(times)}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--wide", action="store_true", help="also time D 256")
    ap.add_argument("--fp32", action="store_true",
                    help="time only the dense dQ and dK/dV on fp32 inputs, beside the SDPA backward")
    ap.add_argument("--ring", action="store_true",
                    help="time only the ring backward kernels, on ring steps and the whole ring")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    if sys.path and os.path.abspath(sys.path[0]) == here:
        sys.path.pop(0)  # run as a script: its own directory would shadow top-level names
    sys.path.insert(0, tree)

    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.engine.config import Precision
    from umfa_tpu_torch.ops import flash_bwd as fb
    from umfa_tpu_torch.ops import quant_bwd as qb
    from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward
    from umfa_tpu_torch.ops.quant_fused_attn import fused_quantize_attend
    from umfa_tpu_torch.utils.testing import rel_err

    if not torch.cuda.is_available():
        print("bwd_timing: no CUDA device", file=sys.stderr)
        return 2
    if not _kernels.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {_kernels.__file__}, not the tree {tree}")
    _kernels.build_all(("ring_attn",) if args.ring else
                       ("flash_fwd", "flash_bwd", "flash_dbias", "quant_bwd", "fused_qattn"))

    def emit(**kw):
        print(json.dumps({"tree": args.label, **kw}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    if args.fp32:
        _time_fp32(randn, emit)
        _print_card()
        return 0
    if args.ring:
        _time_ring(randn, emit, args.wide)
        _print_card()
        return 0

    for d in (64, 128, 256) if args.wide else (64, 128):
        q, k, v = randn((B, HQ, S, d)), randn((B, HKV, S, d)), randn((B, HKV, S, d))
        out, lse = flash_attention_forward(q, k, v, causal=True)
        do = randn(out.shape)
        p = fb._prepare(q, k, v, out, lse, do, None, None, True, None, None)
        bias = torch.randn((1, HQ, S, S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(8))
        out_b, lse_b = flash_attention_forward(q, k, v, bias, causal=True)
        pb = fb._prepare(q, k, v, out_b, lse_b, do, bias, None, True, None, None)
        runs = {
            "flash_bwd_dq": (lambda: (fb._launch_dq(p, torch.bfloat16),),
                             lambda: (fb._plain_dq(p),)),
            "flash_bwd_dkv": (lambda: fb._launch_dkv(p, torch.bfloat16),
                              lambda: fb._plain_dkv(p)),
            "flash_dbias": (lambda: (fb._launch_dbias(pb, tuple(bias.shape)),),
                            lambda: (fb._plain_dbias(pb, tuple(bias.shape)),)),
        }
        for name, (kern, plain) in runs.items():
            err = None
            if d == 64:
                err = max(rel_err(x, y) for x, y in zip(kern(), plain()))
                torch.cuda.empty_cache()
            emit(kernel=name, D=d, **_stats(kern), relerr=err)
        del q, k, v, out, lse, do, p, bias, out_b, lse_b, pb, runs
        torch.cuda.empty_cache()

    q, k, v = randn((B, HQ, S, 64)), randn((B, HKV, S, 64)), randn((B, HKV, S, 64))
    i8 = Precision.INT8
    out, lse, qt_q, qt_k, qt_v, qm, vm = fused_quantize_attend(
        q, k, v, causal=True, q_precision=i8, k_precision=i8, v_precision=i8, smooth=True,
        smooth_q=False)
    do = randn(out.shape)
    p = qb._prepare(qt_q, qt_k, qt_v, out, lse, do, qm, vm, None, None, None, True, None, None)
    emit(kernel="quant_bwd_dq", D=64, **_stats(lambda: qb._launch_dq(p, torch.bfloat16)))
    emit(kernel="quant_bwd_dkv", D=64, **_stats(lambda: qb._launch_dkv(p, torch.bfloat16)))
    _print_card()
    return 0


def _print_card():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0], flush=True)


def _time_fp32(randn, emit):
    """The fp32 dQ, dK/dV and dbias at the training shape, D 64, 128 and
    256, and the memory-efficient SDPA backward on the same inputs (K and V
    expanded to the query heads outside the timing where this torch refuses
    enable_gqa)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from umfa_tpu_torch.ops import flash_bwd as fb
    from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward
    from umfa_tpu_torch.utils.testing import rel_err

    torch.backends.cuda.matmul.allow_tf32 = False
    for d in (64, 128, 256):
        q, k, v = (randn(s, torch.float32) for s in ((B, HQ, S, d), (B, HKV, S, d), (B, HKV, S, d)))
        out, lse = flash_attention_forward(q, k, v, causal=True)
        do = randn(out.shape, torch.float32)
        p = fb._prepare(q, k, v, out, lse, do, None, None, True, None, None)
        bias = torch.randn((1, HQ, S, S), device=q.device,
                           generator=torch.Generator(device=q.device).manual_seed(8))
        out_b, lse_b = flash_attention_forward(q, k, v, bias, causal=True)
        pb = fb._prepare(q, k, v, out_b, lse_b, do, bias, None, True, None, None)
        del out_b, lse_b
        runs = {"flash_bwd_dq": (lambda: (fb._launch_dq(p, torch.float32),),
                                 lambda: (fb._plain_dq(p),)),
                "flash_bwd_dkv": (lambda: fb._launch_dkv(p, torch.float32),
                                  lambda: fb._plain_dkv(p)),
                "flash_dbias": (lambda: (fb._launch_dbias(pb, tuple(bias.shape)),),
                                lambda: (fb._plain_dbias(pb, tuple(bias.shape)),))}
        for name, (kern, plain) in runs.items():
            try:
                got = kern()
            except (ValueError, RuntimeError) as e:  # a tree whose C entry refuses D
                emit(kernel=name, dtype="float32", D=d, refused=str(e))
                continue
            err = [rel_err(x, y) for x, y in zip(got, plain())]
            del got
            torch.cuda.empty_cache()
            # The dbias takes tens of ms a call at D 256: 5 timings after 1 warm-up.
            stats = _stats(kern, iters=5, warmup=1) if name == "flash_dbias" else _stats(kern)
            emit(kernel=name, dtype="float32", D=d, **stats, relerr=err)
        qg = q.detach().requires_grad_(True)

        def grads(kg, vg, **kw):
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, **kw)
            return lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True)

        try:
            kg, vg = k.detach().requires_grad_(True), v.detach().requires_grad_(True)
            fn, gqa = grads(kg, vg, enable_gqa=True), "enable_gqa"
            fn()
        except (RuntimeError, TypeError):
            kg = k.repeat_interleave(HQ // HKV, 1).requires_grad_(True)
            vg = v.repeat_interleave(HQ // HKV, 1).requires_grad_(True)
            fn, gqa = grads(kg, vg), "K and V expanded to the query heads"
        emit(kernel="sdpa_efficient_backward", dtype="float32", D=d, gqa=gqa, **_stats(fn))
        del q, k, v, out, lse, do, p, pb, bias, runs, qg, kg, vg, fn
        torch.cuda.empty_cache()


H100_BF16_FLOPS, H100_TF32_FLOPS, H100_HBM_BYTES = 989e12, 495e12, 3.35e12
RING_N, RING_S_LOC = 4, 1024
# name: (my, src, zigzag); all causal.
RING_STEPS = {"full": (3, 2, False), "diagonal": (3, 3, False),
              "zigzag_first_half_of_keys": (3, 1, True), "zigzag_second_half_of_rows": (1, 3, True)}


def _time_ring(randn, emit, wide):
    """The ring backward kernels on the steps of RING_STEPS, then the whole
    ring backward. A head dim a tree's kernels refuse is printed as such."""
    import torch

    from umfa_tpu_torch.parallel import LocalRing
    from umfa_tpu_torch.parallel import ring_pallas as rp
    from umfa_tpu_torch.utils.testing import rel_err

    s_loc, n = RING_S_LOC, RING_N
    bf16 = torch.bfloat16
    widths = [(bf16, 64), (bf16, 128)] + ([(bf16, 256)] if wide else []) + [(torch.float32, 256)]
    for dtype, d in widths:
        scale = d**-0.5
        fp32, dt = dtype == torch.float32, str(dtype)[6:]
        q, do = randn((B, HQ, s_loc, d), dtype), randn((B, HQ, s_loc, d), dtype)
        k, v = randn((B, HKV, s_loc, d), dtype), randn((B, HKV, s_loc, d), dtype)
        s = torch.matmul(rp._fold(q.float() * scale, HKV), k.float().transpose(-1, -2))
        lse = s.reshape(B, HQ, s_loc, s_loc).logsumexp(-1)  # finite on every row
        delta = randn((B, HQ, s_loc), torch.float32)
        del s
        dk, dv, dq = (torch.zeros(x.shape, device=q.device) for x in (k, v, q))
        for step, (my, src, zigzag) in RING_STEPS.items():
            c = rp._Step(n, my, src, my == src, True, zigzag, scale, 512)
            pairs = B * HQ * int(c.keep(s_loc, q.device).sum())
            reads = (q.element_size() * (q.numel() + k.numel() + v.numel() + do.numel())
                     + 4 * 2 * lse.numel())
            runs = {
                "ring_bwd_dkv": (lambda: rp.ring_bwd_dkv(q, do, lse, delta, k, v, dk, dv, c),
                                 lambda: rp._dkv_plain(q, do, lse, delta, k, v, dk, dv, c),
                                 (dk, dv), 8),
                "ring_bwd_dq": (lambda: rp.ring_bwd_dq(q, do, lse, delta, k, v, dq, c),
                                lambda: rp._dq_plain(q, do, lse, delta, k, v, dq, c), (dq,), 6),
            }
            for name, (kern, plain, outs, flop_per_pair) in runs.items():
                try:
                    kern()
                except ValueError as e:
                    emit(kernel=name, dtype=dt, step=step, D=d, refused=str(e))
                    continue
                got = [x.clone() for x in outs]
                for x in outs:
                    x.zero_()
                plain()
                # Both folded the step into zeroed buffers (or wrote them).
                err = max(rel_err(x, y) for x, y in zip(got, outs))
                flops = flop_per_pair * d * pairs
                nbytes = reads + 2 * 4 * sum(x.numel() for x in outs)  # read and written
                st = _stats(kern)
                ops_s = 3 * flops / H100_TF32_FLOPS if fp32 else flops / H100_BF16_FLOPS
                emit(kernel=name, dtype=dt, step=step, D=d, **st, relerr=err, flops=flops,
                     tflops=flops / st["ms"] / 1e9,
                     bound_ms=max(ops_s, nbytes / H100_HBM_BYTES) * 1e3)
                for x in outs:
                    x.zero_()
                del got
        del q, do, k, v, lse, delta, dk, dv, dq
        torch.cuda.empty_cache()

    s = n * s_loc
    for dtype, d in ((bf16, 64), (torch.float32, 256)):
        dt = str(dtype)[6:]
        q, do = randn((B, HQ, s, d), dtype), randn((B, HQ, s, d), dtype)
        k, v = randn((B, HKV, s, d), dtype), randn((B, HKV, s, d), dtype)
        dlse = randn((B, HQ, s), torch.float32)
        for layout, zigzag in (("causal", False), ("zigzag", True)):
            cfg = rp._config(s_loc, True, zigzag, d**-0.5, None)
            try:
                out, lse = rp._ring_fwd(q, k, v, LocalRing(n), cfg)
                rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(n), cfg)
            except ValueError as e:
                emit(kernel="ring_backward", dtype=dt, layout=layout, D=d, refused=str(e))
                continue
            emit(kernel="ring_backward", dtype=dt, layout=layout, D=d, **_stats(
                lambda: rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(n), cfg), iters=5))
            del out, lse
            torch.cuda.empty_cache()
        del q, do, k, v, dlse
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
