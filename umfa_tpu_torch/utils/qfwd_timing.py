"""Time the INT8 attention forward (`quant_attn_fwd`) of a source tree on the card.

    python umfa_tpu_torch/utils/qfwd_timing.py [--tree DIR] [--label NAME] [--fused | --variants]

Imports `umfa_tpu_torch` from DIR (default: the tree this file is in), so
another tree, such as a parent commit unpacked with `git archive`, can be
timed beside this one: run parent, change, change, parent, each in its own
process, one after another on the same card (each tree builds its kernels
into its own `_build/`). At the serving prefill shape (B8 Hq16 Hkv8, 4032
causal queries against 4096 keys, int8 ROW operands quantized from seeded
bf16 normals) it times `quantized_attention_forward` at D 64, 128 and 256:
median, min and max of 10 CUDA-event timings after 2 warm-up calls, and
at D 64 the worst abs error of out against the plain version. A head dim
the tree's kernel refuses is reported as refused.

With --fused it times `fused_quantize_attend` (`fused_qattn`) instead, at
the training shape (B8 Hq16 Hkv8, causal S 4096, seeded bf16 Q, K, V) under
the int8 and int4 recipes at D 64, 128 and 256, with the worst abs error
of out and of the LSE and the relerr of out against the plain version, and
each kernel's device ms in one call (`kernels_ms`, from torch.profiler over
3 calls); at D 256 also the two-pass route's forward under int8 on the same
inputs (`quant_rows` three times, then `quant_attn_fwd`; other numbers,
true means instead of tile-0 estimates: a yardstick).

With --variants it times the quantized recipes beyond symmetric ROW at the
training shape, D 64: `fused_quantize_attend` under int8 (for comparison),
int8 and int4 with BLOCK scales and int8 and int4 ASYMMETRIC, with
`kernels_ms`; then `quantized_attention_forward` on the two-pass route's
operands under int8 (for comparison), the int4 recipe (INT4 Q and K, the
Q-mean corr row) and ASYMMETRIC int8; each with its worst abs error
against the plain version. A variant the tree refuses is reported as
refused.

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
S_TRAIN = 4096


def _time_quant_attn_fwd(emit):
    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.engine.config import QuantMode
    from umfa_tpu_torch.ops.quant import quantize
    from umfa_tpu_torch.ops.quant_attention import (
        quantized_attention_forward,
        quantized_attention_forward_plain,
    )
    from umfa_tpu_torch.utils.bwd_timing import _stats

    _kernels.build_all(("quant_attn_fwd",))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for d in (64, 128, 256):
        x = [torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
             for shape in ((B, HQ, SQ, d), (B, HKV, SK, d), (B, HKV, SK, d))]
        qt = [quantize(t, mode=QuantMode.ROW) for t in x]
        del x

        def run(qt=qt):
            return quantized_attention_forward(*qt, causal=True)

        try:
            run()
        except ValueError as e:
            emit("quant_attn_fwd", D=d, refused=str(e))
            continue
        err = None
        if d == 64:
            got, want = run()[0], quantized_attention_forward_plain(*qt, causal=True)[0]
            err = float((got - want).abs().max())
            del got, want
            torch.cuda.empty_cache()
        emit("quant_attn_fwd", D=d, **_stats(run), max_abs_err=err)
        del qt
        torch.cuda.empty_cache()


def _kernel_ms(fn, calls=3):
    """{kernel name: device ms per call} of the kernels fn() launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            # "void (anonymous namespace)::name<...>(...)" -> "name"
            name = e.key.split("<")[0].split("::")[-1].split("(")[0].strip()
            name = name.removeprefix("void ").strip() or e.key[:60]
            out[name] = out.get(name, 0.0) + us / calls / 1e3
    return out


def _time_fused(emit):
    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.engine.config import Precision, QuantizationConfig
    from umfa_tpu_torch.ops import quant_attention as qa
    from umfa_tpu_torch.ops.quant_fused_attn import (
        fused_quantize_attend,
        fused_quantize_attend_plain,
    )
    from umfa_tpu_torch.utils.bwd_timing import _stats

    _kernels.build_all(("fused_qattn", "quant_rows", "quant_attn_fwd"))
    i8, i4 = Precision.INT8, Precision.INT4
    recipes = {
        "int8": dict(q_precision=i8, k_precision=i8, v_precision=i8, smooth=True,
                     smooth_q=False),
        "int4": dict(q_precision=i4, k_precision=i4, v_precision=i8, smooth=True, smooth_q=True,
                     hadamard=True),
    }
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for d in (64, 128, 256):
        q = torch.randn((B, HQ, S_TRAIN, d), generator=gen).to(dev, torch.bfloat16)
        k, v = ((torch.randn((B, HKV, S_TRAIN, d), generator=gen) + off).to(dev, torch.bfloat16)
                for off in (0.5, 0.3))
        if d == 256:
            cfg = QuantizationConfig.from_mode_string("int8")

            def two_pass():
                return qa._two_pass(q, k, v, None, cfg, True, None, None, None)

            emit("two_pass_route", recipe="int8", D=d, **_stats(two_pass),
                 kernels_ms=_kernel_ms(two_pass))
        for name, kw in recipes.items():
            def run(kw=kw):
                return fused_quantize_attend(q, k, v, causal=True, **kw)

            try:
                got = run()
            except (ValueError, RuntimeError) as e:  # a tree whose kernel refuses D
                emit("fused_qattn", recipe=name, D=d, refused=str(e))
                continue
            want = fused_quantize_attend_plain(q, k, v, causal=True, **kw)
            out, w_out = got[0].float(), want[0].float()
            err = dict(max_abs_out=float((out - w_out).abs().max()),
                       relerr_out=float((out - w_out).norm() / w_out.norm()),
                       max_abs_lse=float((got[1] - want[1]).abs().max()))
            del got, want, out, w_out
            torch.cuda.empty_cache()
            emit("fused_qattn", recipe=name, D=d, **_stats(run), **err, kernels_ms=_kernel_ms(run))
        del q, k, v
        torch.cuda.empty_cache()


def _time_variants(emit):
    import dataclasses

    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.engine.config import Precision, QuantizationConfig, QuantMode, QuantStrategy
    from umfa_tpu_torch.ops import quant_attention as qa
    from umfa_tpu_torch.ops.quant_fused_attn import (
        fused_quantize_attend,
        fused_quantize_attend_plain,
    )
    from umfa_tpu_torch.utils.bwd_timing import _stats

    _kernels.build_all(("fused_qattn", "quant_rows", "quant_attn_fwd"))
    i8, i4 = Precision.INT8, Precision.INT4
    int8 = dict(q_precision=i8, k_precision=i8, v_precision=i8, smooth=True, smooth_q=False)
    int4 = dict(q_precision=i4, k_precision=i4, v_precision=i8, smooth=True, smooth_q=True,
                hadamard=True)
    block, asym = dict(mode=QuantMode.BLOCK), dict(strategy=QuantStrategy.ASYMMETRIC)
    recipes = {"int8": int8, "int8_block": dict(int8, **block), "int4_block": dict(int4, **block),
               "int8_asym": dict(int8, **asym), "int4_asym": dict(int4, **asym)}
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    d = 64
    q = torch.randn((B, HQ, S_TRAIN, d), generator=gen).to(dev, torch.bfloat16)
    k, v = ((torch.randn((B, HKV, S_TRAIN, d), generator=gen) + off).to(dev, torch.bfloat16)
            for off in (0.5, 0.3))
    refusals = (ValueError, RuntimeError, TypeError, NotImplementedError)
    for name, kw in recipes.items():
        def run(kw=kw):
            return fused_quantize_attend(q, k, v, causal=True, **kw)

        try:
            got = run()
        except refusals as e:
            emit("fused_qattn", recipe=name, D=d, refused=str(e))
            continue
        want = fused_quantize_attend_plain(q, k, v, causal=True, **kw)
        err = dict(max_abs_out=float((got[0].float() - want[0].float()).abs().max()),
                   max_abs_lse=float((got[1] - want[1]).abs().max()))
        del got, want
        torch.cuda.empty_cache()
        emit("fused_qattn", recipe=name, D=d, **_stats(run), **err, kernels_ms=_kernel_ms(run))
    configs = {"int8": QuantizationConfig.from_mode_string("int8"),
               "int4_corr": QuantizationConfig.from_mode_string("int4"),
               "int8_asym": dataclasses.replace(QuantizationConfig(), **asym)}
    for name, cfg in configs.items():
        try:
            qt_q, qt_k, qt_v, _, _, corr = qa._quantize_operands(q, k, v, cfg)

            def run(qts=(qt_q, qt_k, qt_v), corr=corr):
                return qa.quantized_attention_forward(*qts, None, corr, causal=True)

            got = run()
        except refusals as e:
            emit("quant_attn_fwd", recipe=name, D=d, refused=str(e))
            continue
        want = qa.quantized_attention_forward_plain(qt_q, qt_k, qt_v, None, corr, causal=True)
        err = dict(max_abs_out=float((got[0] - want[0]).abs().max()),
                   max_abs_lse=float((got[1] - want[1]).abs().max()))
        del got, want
        emit("quant_attn_fwd", recipe=name, D=d, **_stats(run), **err)
        del qt_q, qt_k, qt_v, corr
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--fused", action="store_true",
                    help="time fused_quantize_attend at the training shape instead")
    ap.add_argument("--variants", action="store_true",
                    help="time the BLOCK, ASYMMETRIC and INT4 variants of both forwards")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    if sys.path and os.path.abspath(sys.path[0]) == here:
        sys.path.pop(0)  # run as a script: its own directory would shadow top-level names
    sys.path.insert(0, tree)

    import torch

    from umfa_tpu_torch import _kernels

    if not torch.cuda.is_available():
        print("qfwd_timing: no CUDA device", file=sys.stderr)
        return 2
    if not _kernels.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {_kernels.__file__}, not the tree {tree}")

    def emit(kernel, **kw):
        print(json.dumps({"tree": args.label, "kernel": kernel, **kw}), flush=True)

    (_time_variants if args.variants else _time_fused if args.fused
     else _time_quant_attn_fwd)(emit)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
