#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`umfa_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device: the card (nvidia-smi name and power limit), torch and CUDA;
  2. build: both CUDA kernels compiled from `umfa_tpu_torch/csrc/`;
  3. kernels against their plain PyTorch versions on the card at the
     serving head geometry (Hq 16 / Hkv 8, D 64, Sk 4096, batch 2), with
     the stated tolerances; then each kernel timed at the prefill shape of
     the serving run (batch 8, 4032 causal queries against 4096 keys)
     beside its plain version, its bound and, for the dense kernel, torch's
     scaled_dot_product_attention (a yardstick only; the port never calls
     it);
  4. serving at full width (vocab 32768, dim 1024, 16/8 heads, D 64, depth
     8, max_seq 4096, bf16, batch 8) for the dense and the INT8 KV cache:
     prefill of 4032 tokens, a 16-token continuation with chunk_start, a
     24-token continuation through the bias route, 16 greedy decode steps,
     once to warm up and once timed, with the launch counts set to 0 just
     before the timed run and read just after; plus a small model checked
     against the plain path on the CPU;
  5. a `kernels` line; the nvidia-smi line; the result line.

Any failed check raises, so the script exits non-zero. Without a CUDA
device, or without the rest of the repository beside it, it exits non-zero
and prints no result. fp32 checks run with TF32 disabled
(torch.backends.cuda.matmul.allow_tf32 and cudnn.allow_tf32 set False).
Details go to chiprun_out/chip_smoke.json.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, bf16
H100_INT8_OPS = 1979e12    # dense tensor-core peak, int8
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s

B_CHECK, B_SERVE = 2, 8
HQ, HKV, D, SK, PROMPT = 16, 8, 64, 4096, 4032


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Median of `iters` CUDA-event timings of fn(), in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(name, got, want, rtol, ltol):
    """Kernel (out, lse) against the plain version's; raises on failure."""
    from umfa_tpu_torch.utils.testing import rel_err

    out, lse = got
    want_out, want_lse = want
    out, want_out = out.float(), want_out.float()
    vis = want_lse > -1e29
    empty = ~vis & (want_out == 0).all(dim=-1)
    res = {
        "case": name,
        "relerr_out": rel_err(out, want_out),
        "max_abs_out": float((out - want_out).abs().max()),
        "max_abs_lse": float((lse[vis] - want_lse[vis]).abs().max()) if vis.any() else 0.0,
        "empty_rows": int(empty.sum()),
        "empty_rows_exact": bool((out[empty] == 0).all() and (lse[empty] == -1e30).all()),
        "finite": bool(torch_isfinite(out) and torch_isfinite(lse)),
        "tol_out": rtol, "tol_lse": ltol,
    }
    res["ok"] = (res["relerr_out"] <= rtol and res["max_abs_lse"] <= ltol
                 and res["empty_rows_exact"] and res["finite"])
    return res


def torch_isfinite(t):
    import torch

    return bool(torch.isfinite(t).all())


def visible_pairs(sq, sk, left, right):
    """Visible (query, key) pairs of one head under the top-left mask."""
    n = 0
    for i in range(sq):
        lo = max(0, i - left) if left >= 0 else 0
        hi = min(sk - 1, i + right) if right >= 0 else sk - 1
        n += max(0, hi - lo + 1)
    return n


def phase_kernels(record):
    import torch
    import torch.nn.functional as F

    from umfa_tpu_torch.engine.config import QuantMode
    from umfa_tpu_torch.ops.flash_fwd import (
        flash_attention_forward, flash_attention_forward_plain,
    )
    from umfa_tpu_torch.ops.quant import quantize
    from umfa_tpu_torch.ops.quant_attention import (
        quantized_attention_forward, quantized_attention_forward_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def qkv(b, sq, sk, dtype):
        q = torch.randn((b, HQ, sq, D), generator=gen)
        k = torch.randn((b, HKV, sk, D), generator=gen)
        v = torch.randn((b, HKV, sk, D), generator=gen)
        return [x.to(dev, dtype) for x in (q, k, v)]

    def path_bias(b, tq, sk, length):
        # The generic decode route's (B, 1, Tq, Sk) length-and-causal bias.
        pos = torch.arange(sk, device=dev)
        qpos = length - tq + torch.arange(tq, device=dev)
        masked = (pos[None, :] > qpos[:, None]) | (pos[None, :] >= length)
        return torch.where(masked, -1e30, 0.0).float()[None, None].expand(b, 1, tq, sk)

    cases = [  # name, sq, sk, kwargs
        ("causal_prefill", PROMPT, SK, dict(causal=True)),
        ("chunk_window", 16, SK, dict(window=(-1, PROMPT))),
        ("bias_tq24", 24, SK, dict(bias=True)),
        ("masked_rows", SK + 64, SK, dict(window=(0, -1))),
    ]
    worst = {"flash_fwd": 0.0, "quant_attn_fwd": 0.0}
    results = []
    for name, sq, sk, kw in cases:
        bias = path_bias(B_CHECK, sq, sk, 4072) if kw.get("bias") else None
        causal, window = kw.get("causal", False), kw.get("window")
        for dtype, rtol, ltol in ((torch.float32, 2e-5, 1e-5), (torch.bfloat16, 1e-2, 1e-3)):
            q, k, v = qkv(B_CHECK, sq, sk, dtype)

            def run(q=q, k=k, v=v):
                return flash_attention_forward(q, k, v, bias, causal=causal, window=window)

            got = run()
            torch.cuda.synchronize()
            want = flash_attention_forward_plain(q, k, v, bias, causal=causal, window=window)
            res = compare(f"flash_fwd/{str(dtype)[6:]}/{name}", got, want, rtol, ltol)
            res["ms"] = cuda_ms(run)
            results.append(res)
            emit({"phase": "kernel_check", **res})
            worst["flash_fwd"] = max(worst["flash_fwd"], res["max_abs_out"])
            del got, want
        q, k, v = qkv(B_CHECK, sq, sk, torch.bfloat16)
        qt = [quantize(x, mode=QuantMode.ROW) for x in (q, k, v)]

        def runq(qt=qt):
            return quantized_attention_forward(*qt, bias, causal=causal, window=window)

        got = runq()
        torch.cuda.synchronize()
        want = quantized_attention_forward_plain(*qt, bias, causal=causal, window=window)
        res = compare(f"quant_attn_fwd/int8/{name}", got, want, 1e-3, 1e-4)
        res["ms"] = cuda_ms(runq)
        results.append(res)
        emit({"phase": "kernel_check", **res})
        worst["quant_attn_fwd"] = max(worst["quant_attn_fwd"], res["max_abs_out"])
        del got, want, qt
    record["kernel_checks"] = results
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    # Timing at the serving prefill shape.
    torch.cuda.empty_cache()
    b, sq, sk = B_SERVE, PROMPT, SK
    pairs = B_SERVE * HQ * visible_pairs(sq, sk, -1, 0)
    q, k, v = qkv(b, sq, sk, torch.bfloat16)
    timing = {}
    fk = lambda: flash_attention_forward(q, k, v, causal=True)  # noqa: E731
    fp = lambda: flash_attention_forward_plain(q, k, v, causal=True)  # noqa: E731
    res = compare("flash_fwd/bfloat16/prefill_b8", fk(), fp(), 1e-2, 1e-3)
    worst["flash_fwd"] = max(worst["flash_fwd"], res["max_abs_out"])
    flops = 4 * D * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + b * HQ * sq * 4  # q, k, v, out; lse
    timing["flash_fwd"] = dict(
        ms=cuda_ms(fk), plain_ms=cuda_ms(fp, iters=3, warmup=1),
        flops=flops, bytes=nbytes,
        ops_ms=flops / H100_BF16_FLOPS * 1e3, bytes_ms=nbytes / H100_HBM_BYTES * 1e3,
    )
    try:
        F.scaled_dot_product_attention(q[:1, :, :64], k[:1, :, :64], v[:1, :, :64],
                                       is_causal=True, enable_gqa=True)
        kl, vl, gqa = k, v, dict(enable_gqa=True)
    except TypeError:  # torch without enable_gqa: expand the heads outside the timing
        kl, vl, gqa = (k.repeat_interleave(HQ // HKV, 1), v.repeat_interleave(HQ // HKV, 1), {})
    # is_causal in SDPA is top-left aligned, as the port's mask.
    timing["flash_fwd"]["library_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(q, kl, vl, is_causal=True, **gqa))
    timing["flash_fwd"]["check"] = res
    del kl, vl
    qt = [quantize(x, mode=QuantMode.ROW) for x in (q, k, v)]
    del q, k, v
    torch.cuda.empty_cache()
    qk = lambda: quantized_attention_forward(*qt, causal=True)  # noqa: E731
    qp = lambda: quantized_attention_forward_plain(*qt, causal=True)  # noqa: E731
    res = compare("quant_attn_fwd/int8/prefill_b8", qk(), qp(), 1e-3, 1e-4)
    worst["quant_attn_fwd"] = max(worst["quant_attn_fwd"], res["max_abs_out"])
    int_ops = bf16_flops = 2 * D * pairs
    nbytes = (sum(t.values.numel() + t.scales.numel() * 4 for t in qt)
              + b * HQ * sq * D * 4 + b * HQ * sq * 4)
    timing["quant_attn_fwd"] = dict(
        ms=cuda_ms(qk), plain_ms=cuda_ms(qp, iters=3, warmup=1),
        int8_ops=int_ops, bf16_flops=bf16_flops, bytes=nbytes,
        ops_ms=(int_ops / H100_INT8_OPS + bf16_flops / H100_BF16_FLOPS) * 1e3,
        bytes_ms=nbytes / H100_HBM_BYTES * 1e3,
        library_ms=None,  # no single PyTorch call computes int8 attention
        check=res,
    )
    del qt
    torch.cuda.empty_cache()
    for name, t in timing.items():
        if not t["check"]["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version at the prefill shape")
        t["bound_ms"] = max(t["ops_ms"], t["bytes_ms"])
        t["bound_by"] = "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes"
        emit({"phase": "kernel_timing", "kernel": name, "shape": f"B{b} Hq{HQ} Hkv{HKV} Sq{sq} Sk{sk} D{D} causal",
              **{k2: v2 for k2, v2 in t.items() if k2 != "check"}})
    record["kernel_timing"] = timing
    return timing, worst


def phase_serving(record):
    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.models import gpt

    dev = torch.device("cuda")
    base = gpt.GPTConfig(vocab=32768, dim=1024, num_heads=HQ, num_kv_heads=HKV, depth=8,
                         max_seq=SK, dtype="bfloat16")
    tok_gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, base.vocab, (B_SERVE, PROMPT), generator=tok_gen).to(dev)
    chunk = torch.randint(0, base.vocab, (B_SERVE, 16), generator=tok_gen).to(dev)
    cont = torch.randint(0, base.vocab, (B_SERVE, 24), generator=tok_gen).to(dev)
    kernel_of = {"dtype": "flash_fwd", "int8": "quant_attn_fwd"}

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def drive(model, cfg):
        """The four routes on fresh caches: 4032 + 16 + 24 + 16 rows."""
        caches = gpt.init_caches(cfg, B_SERVE, device=dev)
        fwd = gpt.forward_with_cache
        (logits, caches), prefill_ms = timed(lambda: fwd(model, prompt, caches, prefill=True))
        finite = torch_isfinite(logits)
        shape_ok = tuple(logits.shape) == (B_SERVE, PROMPT, cfg.vocab)
        del logits
        (logits, caches), chunk_ms = timed(lambda: fwd(model, chunk, caches, chunk_start=PROMPT))
        finite &= torch_isfinite(logits)
        (logits, caches), cont_ms = timed(lambda: fwd(model, cont, caches))
        finite &= torch_isfinite(logits)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out, step_ms = [tok], []
        for _ in range(16):
            (logits, caches), ms = timed(lambda: fwd(model, tok, caches))
            tok = torch.argmax(logits[:, -1:], dim=-1)
            step_ms.append(ms)
            finite &= torch_isfinite(logits)
            out.append(tok)
        return dict(prefill_ms=prefill_ms, chunk_ms=chunk_ms, cont_ms=cont_ms,
                    step_ms=statistics.median(step_ms), finite=finite, shape_ok=shape_ok,
                    fill=int(caches[0].length[0]), tokens=torch.cat(out, dim=1).cpu())

    launches, greedy = {}, {}
    for kind in ("dtype", "int8"):
        cfg = dataclasses.replace(base, kv_cache=kind)
        model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
        drive(model, cfg)  # warm-up: one-time CUDA/cuBLAS set-up stays out of the times
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        r = drive(model, cfg)
        counts = dict(_kernels.launches)
        greedy[kind] = r["tokens"]
        launches[kind] = counts
        res = {
            "phase": "serving", "kv_cache": kind, "batch": B_SERVE, "prompt": PROMPT,
            "prefill_ms": r["prefill_ms"],
            "prefill_tokens_per_s": B_SERVE * PROMPT / r["prefill_ms"] * 1e3,
            "chunk16_ms": r["chunk_ms"], "cont24_bias_ms": r["cont_ms"],
            "decode_ms_per_step": r["step_ms"],
            "decode_tokens_per_s": B_SERVE / r["step_ms"] * 1e3,
            "cache_rows_filled": r["fill"], "launches": counts,
            "logits_finite": r["finite"], "prefill_logits_shape_ok": r["shape_ok"],
        }
        emit(res)
        record.setdefault("serving", []).append(res)
        if not (r["finite"] and r["shape_ok"]):
            raise AssertionError(f"serving with kv_cache={kind}: non-finite or misshaped logits")
        if counts.get(kernel_of[kind], 0) <= 0:
            raise AssertionError(f"kv_cache={kind}: {kernel_of[kind]} was not launched")
        if r["fill"] != PROMPT + 16 + 24 + 16:
            raise AssertionError(f"cache filled to {r['fill']} rows")
        del model
        torch.cuda.empty_cache()
    agree = float((greedy["dtype"] == greedy["int8"]).float().mean())
    emit({"phase": "serving_greedy_agreement", "int8_vs_dense": agree,
          "note": "random weights; information only"})
    record["greedy_agreement"] = agree
    return {k: launches[kind].get(k, 0) for kind, k in kernel_of.items()}


def phase_small_reference(record):
    """A small model through the kernels on the card against the plain
    path on the CPU (the CPU path is held against the JAX package by the
    tests)."""
    import torch

    from umfa_tpu_torch.models import gpt

    worst = 0.0
    for kind in ("dtype", "int8"):
        cfg = gpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2,
                            max_seq=96, kv_cache=kind)
        tokens = torch.randint(0, 64, (2, 60), generator=torch.Generator().manual_seed(3))
        logits = {}
        for dev in ("cuda", "cpu"):
            model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
            caches = gpt.init_caches(cfg, 2, device=dev)
            t = tokens.to(dev)
            out = [gpt.forward_with_cache(model, t[:, :32], caches, prefill=True)[0]]
            out.append(gpt.forward_with_cache(model, t[:, 32:40], caches, chunk_start=32)[0])
            out.append(gpt.forward_with_cache(model, t[:, 40:58], caches)[0])
            for i in range(58, 60):
                out.append(gpt.forward_with_cache(model, t[:, i:i + 1], caches)[0])
            logits[dev] = torch.cat(out, dim=1).cpu()
        err = float((logits["cuda"] - logits["cpu"]).abs().max())
        worst = max(worst, err)
        # fp32 throughout: 1e-4. INT8 cache: the card's and the CPU's fp32
        # matmuls round differently, which may move a K/V element across a
        # quantizer rounding boundary (one int8 code); 1e-2 admits that.
        tol = 1e-4 if kind == "dtype" else 1e-2
        emit({"phase": "small_model_vs_cpu", "kv_cache": kind, "max_abs_logits": err, "tol": tol})
        if not err <= tol:
            raise AssertionError(f"small model on the card differs from the CPU path by {err}")
    record["small_model_max_abs"] = worst


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from umfa_tpu_torch import _kernels  # fails when run without the repository

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    record = {"nvidia_smi": smi}
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    report = _kernels.build_all()
    build = {"seconds": time.perf_counter() - t0, "built": sorted(report)}
    build["ptxas"] = {n: [ln.strip() for ln in r["ptxas"].splitlines()
                          if "registers" in ln or "spill" in ln]
                      for n, r in report.items()}
    emit({"phase": "build", **build})
    record["build"] = build

    timing, worst = phase_kernels(record)
    path_launches = phase_serving(record)
    phase_small_reference(record)

    src = {"flash_fwd": ("umfa_tpu_torch/csrc/flash_fwd.cu", "umfa_tpu/ops/flash_fwd.py:296"),
           "quant_attn_fwd": ("umfa_tpu_torch/csrc/quant_attn_fwd.cu",
                              "umfa_tpu/ops/quant_attention.py:74")}
    kernels = [
        {"name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
         "launches": path_launches[name], "max_abs_err": worst[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"]}
        for name in ("flash_fwd", "quant_attn_fwd")
    ]
    record["kernels"] = kernels
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
