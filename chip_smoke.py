#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`umfa_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device: the card (nvidia-smi name and power limit), torch and CUDA;
  2. build: the ten CUDA kernel libraries compiled from
     `umfa_tpu_torch/csrc/`, one nvcc each, all at once; then the
     tensor-core kernels (the bf16 kernels of `flash_fwd`, `flash_bwd_dq`,
     `flash_bwd_dkv` and `flash_dbias`; `quant_attn_fwd`, `fused_qattn`,
     `quant_bwd_dq`, `quant_bwd_dkv`; the fp32 `flash_fwd`, dQ, dK/dV and
     dbias; `ring_fwd_step`, `ring_bwd_dq`, `ring_bwd_dkv`; `flash_decode`,
     bf16 and tf32): their HMMA
     instructions (IMMA in place of HMMA in the pv_int8 instantiations of
     `quant_attn_fwd` and `fused_qattn`, 12 and 24 of them) (TF32 ones in the fp32 instantiations of the dense
     forward and backward, of the dbias and of the ring kernels, at D 64,
     128 and 256; no CUDA-core kernel left in `flash_fwd`, `flash_bwd`,
     `flash_dbias`, `ring_attn` or `flash_decode`), and for `quant_attn_fwd` also its IMMA
     (int8) ones, for `fused_qattn` its DMMA (f64) ones (its D 256
     instantiations among them), for `mma_probe` its HGMMA (`wgmma`)
     ones (the `mma.sync` probe kernel gone, and no "wgmma ... serialized"
     in its ptxas report), counted in the SASS (cuobjdump; none
     fails the run), their registers and spills (ptxas; a spill in the
     fp32 dbias, in `fused_qattn` at D 256, in a bf16 `flash_decode` or in
     a wide body (`fwd_wide_kernel`, `dq_wide_kernel`, `dkv_wide_kernel`,
     head_dim > 256, bf16 and 3xTF32, with HMMA and TF32 HMMA like the
     rest) fails the run; `quant_rows`' kernels listed too) and dynamic
     shared memory at D 64/128/256, at D 300/512/1024 for rows 1-4 (and of
     each probe plan);
  3. forward kernels against their plain PyTorch versions on the card at
     the serving head geometry (Hq 16 / Hkv 8, D 64, Sk 4096, batch 2),
     with the stated tolerances, and the bf16 `flash_fwd` and the int8
     `quant_attn_fwd` also at D 128 and 256; then each kernel timed at the
     prefill shape of the serving run (batch 8, 4032 causal queries against
     4096 keys; median, min and max of 10) beside its plain version, its
     bound, its TFLOP/s (for `quant_attn_fwd`, int8 ops and bf16 flops
     together) and share of the bound, `quant_attn_fwd`'s worst abs error
     there held to 1e-5, and, for the dense kernel, torch's
     scaled_dot_product_attention (a yardstick only; the port never calls
     it); the fp32 inputs' `flash_fwd` (3xTF32 on the tensor cores) at the
     same shape, D 64 and 256, beside its plain version, its 3xTF32 floor
     and the memory-efficient SDPA forward on the same fp32 inputs (fp32
     also checked at D 192 and 256 at the check shapes);
  4. backward kernels (dQ, dK/dV, dbias) against their plain versions at
     the training head geometry (batch 2, causal 1024, odd 777 x 1000,
     window (128, 0), full and shared biases, fully masked rows, a nonzero
     dlse, D 32/64/128, fp32 and bf16; bf16 and fp32 also at D 256, with a
     shared bias and a window, and fp32 at D 192 with masked rows and with
     a per-head bias; bf16 inputs with fp32 gradients at D 128, 80 and 256,
     gate 5e-4, where a dK from the scaled Q would show; the fp32 dQ, dK/dV
     and dbias at causal 1024, q ~ N(0, 3), D 64/128/256, gate 5e-6); then
     each
     timed at the training shape (batch 8, causal 4096, D 64, bf16; median,
     min and max of 10) beside its plain version, its bound and the SDPA
     backward (flash for dQ + dK/dV, memory-efficient with a bias gradient
     for dbias; yardsticks only); dQ and dK/dV also with fp32 inputs (3xTF32
     on the tensor cores, as int8-qdense runs them), D 64 and 256, beside
     their 3xTF32 floor and the memory-efficient SDPA backward on the same
     fp32 inputs;
     dbias with fp32 inputs (3xTF32 on the tensor cores), D 64 and 256,
     beside its 3xTF32 floor and the memory-efficient SDPA backward with an
     fp32 bias gradient;
  5. serving at full width (vocab 32768, dim 1024, 16/8 heads, D 64, depth
     8, max_seq 4096, bf16, batch 8) for the dense and the INT8 KV cache:
     prefill of 4032 tokens, a 16-token continuation with chunk_start, a
     24-token continuation through the bias route, 16 greedy decode steps,
     once to warm up and once timed; plus a small model checked against
     the plain path on the CPU;
  5a. the flash-decode kernel (`flash_decode`, one launch: the splits
     merge inside it) against its plain tile walk at Hq 16 / Hkv 8 and
     Hq = Hkv 8, Tq 1/4/16, D 64/128/72/256, fp32 and bf16, S_max 4096 (block 2048)
     and 768 (block 256), slot lengths S_max, 1, 0 and S_max/3 + 5 with
     the causal bias of Tq > 1 (fp32 relerr 2e-5, bf16 1e-2, finite); the
     cluster's edges at the same gates: Hq 16 / Hkv 1 at Tq 1 and 16 (D 64,
     256), S_max 64 (block 64) and 1000 (block 1000) at Tq 1 and 16 (D 64,
     72); then timed at the serving decode geometry (B8 Hq16 Hkv8 S4096
     D64 bf16, Tq 1 and 16, full cache, L2 evicted by reads before each
     timing; Tq 1 also at D 256) beside the plain walk, the default gemv
     route and the bound, each with its relerr against the plain walk
     (1e-2) and two calls' bits compared (equal);
  5b. continuous batching at full width: the serving model with the INT8
     cache, 8 slots, 24 seeded requests (prompts 256-3584 tokens, 8-64 new
     tokens, teacher-forced), each admission prefilled into its slot, one
     ragged decode round for all slots, retired slots reset after the
     round; a warm-up run, then runs with UMFA_ENABLE_DECODE_KERNEL=1 and
     without it: every request completes, cache lengths follow the
     schedule, exact launch counts (depth x rounds `flash_decode` with
     the switch, depth x admissions `quant_attn_fwd`, nothing else), and
     the two runs' logits agree (bf16 relerr 2e-2 each round);
  5c. a small model's continuous-batching loop with the switch on, on the
     card against the CPU (INT8 cache max abs 1e-2, dense 1e-4);
  6. training at full width (the same model, batch 8 rows of 4097 tokens,
     the next-token cross-entropy in fp32, `.backward()`, plain SGD with
     lr TRAIN_LR): one warm-up step and three timed steps on one batch,
     each with a finite loss below the step before's and exactly
     8 flash_fwd, 8 flash_bwd_dq, 8 flash_bwd_dkv and 0 flash_dbias
     launches; plus a small model's loss and every gradient on the card
     against the plain path on the CPU;
  7. the public `attention()` on the card with gradients (a float bias with
     bias_grad=True, a bool mask, a float bias with bias_grad=False)
     against the CPU path, through the fused route only;
  7a. block-sparse masks (ops/block_mask.py) through the walked
     instantiations of `flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv`:
     (a) each against its plain version at B2 Hq16 Hkv8, S 1024 and odd
     777 x 1000, D 64/128/256, fp32 and bf16, under causal_block_mask,
     sliding_window_block_mask(128, 0), causal segments of seeded uneven
     documents with a -1 tail (rows that see no key inside PARTIAL tiles,
     held to the same gates), a per-head map under GQA, BlockSizes(96, 160)
     and documents of 512 (no bias), with a nonzero dlse (the table's
     gates: forward fp32 2e-5 / LSE 1e-5, bf16 1e-2 / LSE 1e-3, a row past
     it held to it against the float64 LSE; backward fp32 1e-4, bf16
     2e-2); (b) the
     full-width path, `attention(q, k, v, mask)` and `.backward()` at B8
     Hq16 Hkv8 S4096 D64 bf16 for causal documents of 512, causal documents
     of seeded lengths 64-1536 with a -1 tail, and
     sliding_window_block_mask(4096, 4096, 512, 0): exactly 1 flash_fwd, 1
     flash_bwd_dq, 1 flash_bwd_dkv and 0 flash_dbias launches each, the
     output and gradients against the plain versions (1e-2 / 2e-2), each
     kernel timed beside the dense causal kernels, its bound on the mask's
     visible pairs, the walked share, and the memory-efficient SDPA with
     the bool mask (a yardstick only); (c) the reference's masks cell (B2
     H16 S4096 D64 bf16, 8 documents of 512, non-causal) forward beside the
     dense non-causal `flash_fwd`;
  7b. block-sparse masks on the quantized routes, through the walked
     instantiations of `fused_qattn`, `quant_attn_fwd`, `quant_bwd_dq` and
     `quant_bwd_dkv`: (a) each against its plain version at B2 Hq16 Hkv8,
     S 1024 and 768 x 1000, D 64/128/256, bf16, under causal_block_mask,
     causal segments of seeded uneven documents with a -1 tail and batch 0
     left-padded (its first fill, and so its K/V means window, not tile 0),
     a per-head map under GQA, BlockSizes(96, 160) and documents of 512 (no
     bias); fused_qattn under int8, int4, int8 BLOCK, int8 ASYMMETRIC and
     int8-qdense, quant_attn_fwd under int8, the int4 recipe with its corr
     row and ASYMMETRIC, the backward on the int8 and int4 residuals
     (smoothing on, a nonzero dlse), at the gates of their unwalked
     instantiations (rows that see no key among them, the same bits twice
     for fused_qattn); (b) the full-width path, `attention(q, k, v, mask)`
     and `.backward()` (out and LSE cotangents) at B8 Hq16 Hkv8 S4096 D64
     bf16 under int8, int4, int8 BLOCK and int8 ASYMMETRIC, for causal
     documents of 512 and of seeded lengths 64-1536 with a -1 tail, and the
     two-pass route (512, bias_grad=True): exact launches (the unwalked
     route's, the walked kernels in its place), out, LSE and gradients
     against the same path with every kernel wrapper's plain version, each
     walked kernel timed beside the same recipe's unwalked causal kernel,
     the walked share and its bound on the mask's visible pairs;
  8. the quantized training kernels (quant_rows, fused_qattn, quant_bwd_dq,
     quant_bwd_dkv) against their plain versions at B2 Hq16 Hkv8 (causal
     1024, odd 777, window (128, 0), a shared bias, a left-only window with
     rows that see no key, D 32/64/128/256, fp32 and bf16, the int8 and
     int4 recipes, smoothing off, a dense Q, and BLOCK and ASYMMETRIC
     (int8, int4, both, a dense Q; zero points at most one apart); the
     backward with 64 masked rows and a nonzero dlse on the kernel's
     residuals (BLOCK's too); fused_qattn's LSE held to 1e-5 at causal
     1024, q ~ N(0, 3), D 64 and 256, also under BLOCK and ASYMMETRIC: the
     scores keep their bits; quant_attn_fwd under INT4 with the corr row,
     ASYMMETRIC int8 and both, D 64/128/256/66, at its INT8 gates); then
     each timed at the training shape (B8, causal 4096, D 64, bf16, int8
     recipe; fused_qattn also under int4, int8 and int4 BLOCK, int8 and
     int4 ASYMMETRIC, and at D 256 under int8 beside the two-pass route's
     forward on the same inputs; quant_attn_fwd on the two-pass route's
     operands under int8, the int4 recipe and ASYMMETRIC int8; median, min
     and max of 10) beside its plain version, its
     bound, TFLOP/s and share of the bound (fused_qattn also its FP64
     floor, both passes' QKᵀ in double at the FP64 tensor rate, and its
     worst LSE abs error, held to 1e-5) and, for the backward, the flash
     SDPA backward on the dequantized operands (a yardstick only);
  8a. pv_int8, the integer P·V: `fused_qattn`'s PV instantiation against
     its plain version at the training shape (B8 Hq16 Hkv8 S4096 D64
     causal bf16, int8 ROW) and at B2 under int8 BLOCK, a dense Q, D 128
     and 256, non-causal, and causal documents of 512 under a BlockMask;
     `quant_attn_fwd`'s at the prefill shape (int8) and under the int4
     recipe (INT4 Q and K, the corr row), V per the reference's KV tile;
     out relerr 1e-3, LSE 1e-3, V's residual codes at most one apart, and
     the count of P codes that differ from the plain version's; each timed
     (median, min and max of 10) beside the same call without pv_int8, its
     plain version and its bound (P·V at the int8 rate; row 7 also its
     FP64 floor); then the accuracy cell of bench.py:852-884 (B2 H16 S4096
     D64, iid bf16, non-causal): int8 and int8 pv_int8 against fp64
     attention, beside the v5e history, pv_int8 held to 0.02;
  9. quantized training at full width (the same model and batch, lr
     TRAIN_LR): the int8 recipe for a warm-up and three SGD steps, int4,
     int8-qdense, int8 and int4 with BLOCK scales and int8 ASYMMETRIC for
     a warm-up and one each, int8 with pv_int8 for a warm-up and three;
     each step with a finite loss below the step before's and exactly 8
     fused_qattn launches (8 of them `fused_qattn/pv` under pv_int8) and 8
     of each backward kernel of its route (quant_bwd_dq/dkv, or
     flash_bwd_dq/dkv for the dense Q and ASYMMETRIC), none of the others;
     then int8 pv_int8 once on the two-pass route (16 quant_rows, 8
     quant_attn_fwd, all `quant_attn_fwd/pv`, 8 of each quantized backward
     kernel);
 10. `attention()` under int8 through the two-pass route (quant_rows three
     times, quant_attn_fwd once, then the backward kernels) with
     UMFA_DISABLE_FUSED_QUANT=1 (at D 64 and 63: codes zero-padded to 64
     for quant_attn_fwd) and with causal Sq 512 against Sk 1024, the int4
     recipe (INT4 Q/K and the corr row), ASYMMETRIC int8 and BLOCK int8 on
     the two-pass route, set_quantization_mode("int8", "block") and HYBRID
     on data that picks BLOCK on the single-launch route, each with its
     exact launches; a small quantized model's loss and gradients (int8,
     int4, int8 BLOCK, int8 ASYMMETRIC), and quantized `attention()` with a
     bias gradient, each on the card against the CPU path;
 11. the ring kernels (`ring_fwd_step`, `ring_bwd_dkv`, `ring_bwd_dq`): the
     ring over LocalRing with its kernels against the same ring with their
     plain versions at B2, Hq16/Hkv8 and Hq = Hkv = 8, S 1024 over 4 and 2
     ranks, D 64/128, fp32 and bf16, contiguous causal, zigzag causal and
     non-causal, the backward with a nonzero dlse (forward fp32 2e-5 / LSE
     1e-5, bf16 1e-2 / 1e-3; backward fp32 1e-4, bf16 2e-2); then S 384
     over 4 ranks (a local chunk of 96, zigzag halves of 48), fp32 and bf16,
     and D 256, fp32 and bf16, contiguous and zigzag causal, at the same
     gates; the
     kernel backward against the UMFA_RING_BWD=jnp route (fp32 2e-5);
 12. the one-device self-loop checks at the reference's defaults (B1 H2
     S1024 D128 bf16; n_steps 4 causal and 3 non-causal), each with one
     launch of each ring kernel and n_steps - 1 hops per buffer;
 13. the ring at full width (B8 Hq16 Hkv8 S4096 D64 bf16 over
     LocalRing(4), contiguous causal and zigzag causal): forward and
     `.backward()` of sum(out · cos out) plus a term on LSE, against
     single-device `flash_attention` on the unsharded sequence (out 1e-2,
     gradients 2e-2), with exact launch counts (10 / 16 of each ring
     kernel, no other kernel) and hops (forward 6 / 12; backward 12 K/V,
     12 dK/dV, 4 homing); each ring kernel timed on one rank's chunk beside
     its plain version and its bound (`ring_fwd_step` also on fp32 inputs,
     beside its 3xTF32 floor; all three also on fp32 inputs at D 256); the
     whole ring beside the port's
     flash kernels and SDPA on the unsharded sequence (yardsticks only);
     one hop's copy time, and from a torch.profiler trace how much of the
     hops' copy time ran under ring kernels;
 14. the tensor-core probe `mma_probe` at the five shapes of
     scripts/d64_ab.py against its plain version at reps 1 and 8 (fp32
     1e-5; the same bits twice), then at reps 1024 with its TFLOP/s beside
     989, its plan (tile, K split, work items, SMs used) and one cuBLAS
     product of each shape (a yardstick only);
 14a. rope_attention(interleaved=False) through the ROPE instantiation of
     `flash_fwd` (Q and K rotated inside the kernel) at FLUX (B1 H24 S4608
     D128 non-causal) and S4K (B2 H16 S4096 D64 causal) in bf16, and S4K
     in fp32: the kernel's out and LSE against its plain version (row 1's
     gates), the path's forward and `.backward()` with exactly one
     flash_fwd (one flash_fwd/rope), flash_bwd_dq and flash_bwd_dkv launch
     against the same path with every wrapper's plain version (out 1e-2,
     gradients 2e-2 in bf16; out 2e-5, gradients 1e-4 in fp32), and the
     in-kernel forward timed
     beside the two-pass route (apply_rope on Q and K, then flash_fwd), its
     plain version, its bound and SDPA on the pre-rotated Q and K (a
     yardstick only); the sass phase also requires the twelve ROPE
     instantiations of `fwd_tc_kernel`;
 14b. the FLUX-shaped DiT (models/dit.py) at full width (dim 1536, 24 heads
     of 64, depth 4, B1 S4608, bf16) dense, int8 and int4: a timed forward
     and a warm-up and three plain-SGD steps (lr DIT_LR, an MSE to x plus
     DIT_NOISE noise) whose loss falls, with exact launches (rows 1-3 dense,
     7-9 quantized, once a block), forward and step ms and peak memory;
     the first block's bf16 q, k, v (B1 H24 S4608 D64, non-causal) through
     the recipe's attention call with the LSE and the backward of a seeded
     dO, each kernel launched once, against the same call with every
     wrapper's plain version (dense out 1e-2, LSE 1e-3; int8 and int4 out
     1e-3, LSE 1e-4; gradients 2e-2); then a reduced DiT (depth 1, S 512, fp32) through the kernels against
     the same model with every wrapper's plain version on the card (loss
     abs 1e-5, gradients 1e-4 dense; loss 1e-4, gradient relerr 1e-2
     int8/int4);
 14c. MLA and the DeepSeek-style model (models/mla_model.py, moe.py,
     deepseek.py) in bf16: (a) the MLA forward at bench.py's geometry (dim
     1024, 16 heads of 64, latent 128, B8 S4096 causal), dense and with
     the indexer's top-128 bias, each with exactly one flash_fwd launch,
     timed (median, min, max of 5), its recorded flash_fwd call against the
     plain version at row 1's bf16 gates (every visible row's LSE within
     1e-3), timed beside its bound and the memory-efficient SDPA forward on
     the same float mask (a yardstick only); (b) bench.py's MLA decode parity:
     8 absorbed decode steps (the latent cache filled to 4032) against 8
     steps of the dense route (decompressed K/V in a bf16 KVCache,
     decode_attention's gemv route) from the same state, relerr 1e-2 beside
     the TPU's 0.0034, no launch, each route's ms per step and cache bytes;
     (c) the DeepSeek demo model (vocab 512, dim 512, 8 heads, latent 64,
     depth 2, 16 experts, top 4, one shared) at B8: the forward on 4096
     tokens (finite, aux >= depth, exactly 2 flash_fwd launches, timed) and
     greedy generate from 1024 prompt tokens, 32 new (in range, the same
     tokens twice, no launch, prefill and per-step ms); (d) the reduced fp32
     DeepSeek through the kernel against its plain versions (routes first,
     logits abs 1e-5; decode against forward 5e-3); (e) quantized_matmul at
     x (4096, 1024) @ W (1024, 1024): W8A16, W4A16, W8A8 against x @ W (0.01,
     W4A16_GATE, 0.02) and against the float64 product of their own
     quantized operands (1e-6), centered INT4 on shifted columns, and W8A8's
     integer sums equal to an int64 product;
 14d. MLA and DeepSeek training: the MLA layer at (a)'s geometry with the
     top-128 indexer (loss mean(forward(x)²), lr MLA_TRAIN_LR) and the
     DeepSeek demo model at B8 S4096 (next-token cross-entropy plus aux, lr
     DS_TRAIN_LR), each a warm-up and three plain-SGD steps with a falling
     loss and exactly one flash_fwd, flash_bwd_dq and flash_bwd_dkv launch
     a layer and no flash_dbias, forward, backward and SGD ms and peak
     memory; each model's first recorded attention call through rows 1-3
     against the same call with every wrapper's plain version (out 1e-2,
     LSE 1e-3, gradients 2e-2), and dQ and dK/dV timed on it beside their
     bounds and torch's SDPA backward (a yardstick only);
 16. the SDPA override (utils/interop.py) at the GPT's width: a plain-torch
     stack of two attention layers (dim 1024, Hq 16 / Hkv 8 with
     enable_gqa, D 64, B8 S4096, causal, bf16) calling
     F.scaled_dot_product_attention under use_torch_sdpa(), forward and
     backward: one launch of each of rows 1-3 a layer, the route counted,
     its output bit for bit the stack calling attention() directly, within
     1e-2 of torch's own SDPA with the override removed; then
     nn.MultiheadAttention (dim 1024, 16 heads) under the override, its
     launches reported;
 17. the utilities on the card: the full-width GPT's parameters through
     checkpoint.save/restore (bit for bit), time_op on row 1 at the
     prefill shape within 10 % of cuda_stats' median, a profiling.trace of
     one MLA training step naming flash_fwd, flash_bwd_dq and
     flash_bwd_dkv (chiprun_out/mla_step_trace/), the native runtime's
     version and a timed() latency, an AttentionDescriptor at the prefill
     shape equal to attention();
 18. the mesh on one card (parallel/mesh.py, sharded.py, pipeline.py; the
     DiT's tp/sp and the MoE's ep routes): make_mesh over [cuda] * 8
     virtual ranks; (a) sharded_attention at B8 Hq16 Hkv8 S4096 D64 bf16
     causal, the heads/batch route on dp2/tp4, the sequence route on
     dp1/sp4/tp2 (contiguous and zigzag), the int8 heads route on tp8, each
     with exact launches (dp·tp of row 1, dp·tp·sp² on the ring, dp·tp of
     row 7), held to one unsharded call (out relerr 1e-2; int8 1e-3) and
     timed beside it; (b) the quantized ring's accuracy cell
     (tests/test_parallel.py:257-304's data at that width, fp32) against
     float64 attention: under 0.03 and at most 1.5 × the single int8 call's
     error + 5e-3, beside the reference's 1.15e-2; (c) the FLUX-shaped DiT
     (dim 1536, 24 heads, depth 4, B1 S4608, bf16) on dp1/sp4/tp2: the
     forward within DIT_MESH_GATE of the single-device DiT with the same
     weights, the first ring step's attention call against its plain
     versions (rows 1-3's gates), a warm-up and three SGD steps whose loss
     falls, exact launches (depth·tp·sp² of rows 1-3), forward and step ms
     and peak memory; the int8 DiT on tp8 the same way (rows 7-9); (d)
     pipeline_apply over four DiT blocks (pp 4, M 8, x B8 S1024, a fixed
     cond): S·(S + M − 1) launches of row 1 and S·(S + M − 2) + 1 of rows
     2-3, output and gradients against the sequential loop (1e-2, 2e-2);
     (e) the MoE at the DeepSeek demo's width (dense dispatch, B8 S4096):
     ep 8 against no ep_axis (relerr 1e-2, aux equal), both timed; (f)
     each of the five examples' main() on the card (the SDPA replacement's
     relerrs within 1e-3);
 19. wide heads, rows 1-4 above head_dim 256 (csrc/wide_tc.cuh; dbias's
     own body): (a) the FLUX VAE decoder's mid-block call at full width
     (B1 H1 S16384 D512, one head of 512 channels, non-causal;
     utils/fwd_timing.py WIDE_SHAPE) through F.scaled_dot_product_attention
     under use_torch_sdpa() and no_grad, bf16 and fp32: exactly 2
     flash_fwd launches (the row-max pass, then the column slices), its
     output the kernel's bit for bit, out and LSE against the plain
     version (bf16 1e-2 / 1e-3, fp32 2e-5 / 1e-5); (b) attention() forward and `.backward()` at the same shape:
     exactly 2 flash_fwd, 1 flash_bwd_dq, 1 flash_bwd_dkv, dQ, dK and dV
     against the plain backward (bf16 2e-2, fp32 1e-4); (c) bias_grad=True
     at B1 H2 S2048 D512 with a (1, 2, S, S) fp32 bias (also 1 flash_dbias)
     and causal GQA (B1 Hq4 Hkv2 S1024) at D 300 and 1024 (at 1024 with a
     (1, 4, S, S) bias gradient), each against its plain versions; each
     kernel timed at the VAE shape, the bias case and D 1024 (median, min
     and max of 10) beside its plain version, its bound, its plan (depth
     chunks, column slices, as umfa_flash_wide_plan reports it) and the
     memory-efficient SDPA (a yardstick only: its forward, its backward,
     for dbias its backward with a bias gradient; null with torch's reason
     where it refuses);
 Last: the wall seconds of each phase; a `kernels` line (each kernel with
     its `design`: tensor cores or CUDA cores); the nvidia-smi line; the
     result line.
Every path (each serving run, both timed continuous-batching runs, the
timed training steps, the attention() phase, the three full-width
block-sparse runs and the nine quantized ones, the two full-width ring runs,
the probe's five reps-1024 calls, the three rope_attention paths, the
DiT's forwards and timed steps, the pv_int8 accuracy cell's two calls and
its two-pass training step, the two MLA forwards, both MLA decode routes,
the DeepSeek forward and its generate, the MLA and DeepSeek timed training
steps, the override's stacks and nn.MultiheadAttention, the descriptor and
attention() calls, the traced MLA step, and phase 18's sharded calls, its
quantized ring, its DiT forwards and timed steps, the pipeline's forward
and backward, both MoE calls and each example, and phase 19's override
calls and attention() calls) is driven with the launch counts set to 0
just before it and read just after; a kernel's `launches` in the kernels
line is its sum over them; `launches_pv` of `fused_qattn` and
`quant_attn_fwd`, and `launches_rope` of `flash_fwd`, their PV and ROPE
instantiations' share, each of which must be positive.

Any failed check raises, so the script exits non-zero. Without a CUDA
device, or without the rest of the repository beside it, it exits non-zero
and prints no result. It builds the kernels with nvcc and the native
runtime (native/src) with the host C++ compiler ($CXX, else g++). fp32 checks run with TF32 disabled
(torch.backends.cuda.matmul.allow_tf32 and cudnn.allow_tf32 set False).
Details go to chiprun_out/chip_smoke.json.
"""

import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, bf16
H100_FP32_FLOPS = 67e12    # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12   # dense tensor-core peak, TF32
H100_FP64_TC_FLOPS = 67e12  # FP64 tensor cores (mma.sync f64)
H100_INT8_OPS = 1979e12    # dense tensor-core peak, int8
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s

B_CHECK, B_SERVE = 2, 8
HQ, HKV, D, SK, PROMPT = 16, 8, 64, 4096, 4032
B_TRAIN, S_TRAIN = 8, 4096
TRAIN_LR = 10.0  # plain SGD on the bf16 parameters; see PERF.md
N_REQUESTS, SLOTS = 24, 8  # continuous batching at full width
PROMPT_RANGE, NEW_RANGE = (256, 3584), (8, 64)
DECODE_SWITCH = "UMFA_ENABLE_DECODE_KERNEL"
# quant_attn_fwd against its plain version at the prefill shape: the same
# scores and bf16(P), only the order of the fp32 sums differs.
QUANT_PREFILL_MAX_ABS = 1e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=10, warmup=2, before=None):
    """Median of `iters` CUDA-event timings of fn(), in ms. `before()` runs
    ahead of each timing, outside it (an L2 flush, say)."""
    return cuda_stats(fn, iters, warmup, before)["ms"]


def cuda_stats(fn, iters=10, warmup=2, before=None):
    """Median, min and max of `iters` CUDA-event timings of fn(), in ms:
    {"ms", "ms_min", "ms_max"}."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return {"ms": statistics.median(times), "ms_min": min(times), "ms_max": max(times)}


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


def bound(t):
    """Add a timing's bound (the larger of its operation and byte times),
    what bounds it, its rate in TFLOP/s where it counts flops, and its
    share of the bound."""
    t["bound_ms"] = max(t["ops_ms"], t["bytes_ms"])
    t["bound_by"] = "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes"
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    if "flops" in t:
        t["tflops"] = t["flops"] / t["ms"] / 1e9


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
    from torch.nn.attention import SDPBackend, sdpa_kernel

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

    def qkv(b, sq, sk, dtype, d=D):
        q = torch.randn((b, HQ, sq, d), generator=gen)
        k = torch.randn((b, HKV, sk, d), generator=gen)
        v = torch.randn((b, HKV, sk, d), generator=gen)
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
    # The tensor-core kernels (bf16 flash_fwd, int8 quant_attn_fwd) at the
    # wider head dims they take.
    for name, sq, sk, kw, d in (("causal_prefill_d128", PROMPT, SK, dict(causal=True), 128),
                                ("masked_rows_d128", SK + 64, SK, dict(window=(0, -1)), 128),
                                ("causal_prefill_d256", PROMPT, SK, dict(causal=True), 256),
                                ("masked_rows_d256", SK + 64, SK, dict(window=(0, -1)), 256),
                                ("bias_tq24_d256", 24, SK, dict(bias=True), 256)):
        bias = path_bias(B_CHECK, sq, sk, 4072) if kw.get("bias") else None
        causal, window = kw.get("causal", False), kw.get("window")
        q, k, v = qkv(B_CHECK, sq, sk, torch.bfloat16, d)

        def run(q=q, k=k, v=v):
            return flash_attention_forward(q, k, v, bias, causal=causal, window=window)

        got = run()
        torch.cuda.synchronize()
        want = flash_attention_forward_plain(q, k, v, bias, causal=causal, window=window)
        res = compare(f"flash_fwd/bfloat16/{name}", got, want, 1e-2, 1e-3)
        res["ms"] = cuda_ms(run)
        results.append(res)
        emit({"phase": "kernel_check", **res})
        worst["flash_fwd"] = max(worst["flash_fwd"], res["max_abs_out"])
        del got, want
        qt = [quantize(x, mode=QuantMode.ROW) for x in (q, k, v)]
        del q, k, v

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
    # The fp32 flash_fwd at the head dims of its wide 3xTF32 tile (D 192
    # padded to 256): 8 warps on 128 query rows, 16-key tiles.
    for name, sq, sk, kw, d in (("causal_prefill_d256", PROMPT, SK, dict(causal=True), 256),
                                ("masked_rows_d256", SK + 64, SK, dict(window=(0, -1)), 256),
                                ("bias_tq24_d256", 24, SK, dict(bias=True), 256),
                                ("chunk_window_d192", 16, SK, dict(window=(-1, PROMPT)), 192),
                                ("causal_prefill_d192", PROMPT, SK, dict(causal=True), 192)):
        bias = path_bias(B_CHECK, sq, sk, 4072) if kw.get("bias") else None
        causal, window = kw.get("causal", False), kw.get("window")
        q, k, v = qkv(B_CHECK, sq, sk, torch.float32, d)

        def run(q=q, k=k, v=v):
            return flash_attention_forward(q, k, v, bias, causal=causal, window=window)

        got = run()
        torch.cuda.synchronize()
        want = flash_attention_forward_plain(q, k, v, bias, causal=causal, window=window)
        res = compare(f"flash_fwd/float32/{name}", got, want, 2e-5, 1e-5)
        res["ms"] = cuda_ms(run)
        results.append(res)
        emit({"phase": "kernel_check", **res})
        worst["flash_fwd"] = max(worst["flash_fwd"], res["max_abs_out"])
        del got, want, q, k, v
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
        **cuda_stats(fk), plain_ms=cuda_ms(fp, iters=3, warmup=1),
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
    # fp32 inputs take the 3xTF32 instantiations: their lines at the same
    # shape, at D 64 and at D 256 (the wide tile). Bound: the 3xTF32 floor
    # (three TF32 products for each fp32 one at the TF32 peak; the dense
    # backward's fp32 lines use it too), with the fp32 CUDA-core time of the
    # same flop beside it; yardstick: the memory-efficient SDPA forward on
    # the same fp32 inputs.
    shapes = {"flash_fwd": f"B{b} Hq{HQ} Hkv{HKV} Sq{sq} Sk{sk} D{D} causal bf16"}
    for name, d in (("flash_fwd_fp32", D), ("flash_fwd_fp32_d256", 256)):
        if d == D:
            qf, kf, vf = (x.float() for x in (q, k, v))
        else:
            qf, kf, vf = qkv(b, sq, sk, torch.float32, d)
        fk32 = lambda: flash_attention_forward(qf, kf, vf, causal=True)  # noqa: E731
        fp32 = lambda: flash_attention_forward_plain(qf, kf, vf, causal=True)  # noqa: E731
        res = compare(f"flash_fwd/float32/prefill_b8_d{d}", fk32(), fp32(), 2e-5, 1e-5)
        worst["flash_fwd"] = max(worst["flash_fwd"], res["max_abs_out"])
        flops32 = 4 * d * pairs
        nbytes = 4 * (2 * qf.numel() + kf.numel() + vf.numel()) + b * HQ * sq * 4
        t = dict(**cuda_stats(fk32, iters=5, warmup=1), plain_ms=cuda_ms(fp32, iters=3, warmup=1),
                 flops=flops32, bytes=nbytes, ops_ms=3 * flops32 / H100_TF32_FLOPS * 1e3,
                 bytes_ms=nbytes / H100_HBM_BYTES * 1e3, check=res)
        t["tf32x3_floor_ms"] = t["ops_ms"]
        t["fp32_cuda_core_ms"] = flops32 / H100_FP32_FLOPS * 1e3
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                F.scaled_dot_product_attention(qf[:1, :, :64], kf[:1, :, :64], vf[:1, :, :64],
                                               is_causal=True, enable_gqa=True)
            kl, vl, gqa, how = kf, vf, dict(enable_gqa=True), "enable_gqa"
        except (RuntimeError, TypeError):
            kl, vl = kf.repeat_interleave(HQ // HKV, 1), vf.repeat_interleave(HQ // HKV, 1)
            gqa, how = {}, "K and V expanded to 16 heads outside the timing (enable_gqa refused)"
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            t["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qf, kl, vl, is_causal=True, **gqa))
        t["library"] = "memory-efficient SDPA forward on the fp32 inputs, " + how
        timing[name] = t
        shapes[name] = f"B{b} Hq{HQ} Hkv{HKV} Sq{sq} Sk{sk} D{d} causal fp32"
        del qf, kf, vf, kl, vl
        torch.cuda.empty_cache()
    shapes["quant_attn_fwd"] = shapes["flash_fwd"]
    qt = [quantize(x, mode=QuantMode.ROW) for x in (q, k, v)]
    del q, k, v
    torch.cuda.empty_cache()
    qk = lambda: quantized_attention_forward(*qt, causal=True)  # noqa: E731
    qp = lambda: quantized_attention_forward_plain(*qt, causal=True)  # noqa: E731
    res = compare("quant_attn_fwd/int8/prefill_b8", qk(), qp(), 1e-3, 1e-4)
    worst["quant_attn_fwd"] = max(worst["quant_attn_fwd"], res["max_abs_out"])
    if res["max_abs_out"] > QUANT_PREFILL_MAX_ABS:
        raise AssertionError(f"quant_attn_fwd at the prefill shape: max abs error "
                             f"{res['max_abs_out']} > {QUANT_PREFILL_MAX_ABS}")
    int_ops = bf16_flops = 2 * D * pairs
    nbytes = (sum(t.values.numel() + t.scales.numel() * 4 for t in qt)
              + b * HQ * sq * D * 4 + b * HQ * sq * 4)
    timing["quant_attn_fwd"] = dict(
        **cuda_stats(qk), plain_ms=cuda_ms(qp, iters=3, warmup=1),
        flops=int_ops + bf16_flops,  # int8 ops and bf16 flops together
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
            raise AssertionError(f"{name} disagrees with its plain version at the prefill shape: "
                                 f"{t['check']}")
        bound(t)
        emit({"phase": "kernel_timing", "kernel": name, "shape": shapes[name],
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
    return list(launches.values())


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


def decode_inputs(b, hq, hkv, tq, d, s_max, dtype, lengths, seed):
    """On the card: an INT8 cache of random codes and scales with the given
    slot lengths, queries, and the decode route's length-and-causal bias
    (query t sits at length - Tq + t)."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randint(-128, 128, (b, hkv, s_max, d), generator=g, dtype=torch.int8, device=dev)
    v = torch.randint(-128, 128, (b, hkv, s_max, d), generator=g, dtype=torch.int8, device=dev)
    ks = torch.rand((b, hkv, s_max, 1), generator=g, device=dev) * 0.05 + 1e-3
    vs = torch.rand((b, hkv, s_max, 1), generator=g, device=dev) * 0.05 + 1e-3
    lengths = torch.tensor(lengths, device=dev)
    pos = torch.arange(s_max, device=dev)
    qpos = lengths[:, None] - tq + torch.arange(tq, device=dev)
    masked = (pos[None, None] > qpos[:, :, None]) | (pos[None, None] >= lengths[:, None, None])
    bias = torch.where(masked, -1e30, 0.0)[:, None]
    q = torch.randn((b, hq, tq, d), generator=g, device=dev).to(dtype)
    return q, k, ks, v, vs, bias, lengths.int()


def phase_decode_kernel(record):
    """Row 10 (`flash_decode`, one launch) against the plain tile walk,
    then timed at the serving decode geometry beside the plain walk, the
    gemv route and the bound."""
    import ctypes

    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.serving import decode_kernel as dk
    from umfa_tpu_torch.serving.decode import _gemv_decode
    from umfa_tpu_torch.serving.kv_cache import QuantizedKVCache
    from umfa_tpu_torch.utils.testing import rel_err

    results = []
    dtypes = ((torch.float32, 2e-5), (torch.bfloat16, 1e-2))

    def check(hq, hkv, tq, d, s_max, bk):
        for dtype, tol in dtypes:
            q, k, ks, v, vs, bias, _ = decode_inputs(
                4, hq, hkv, tq, d, s_max, dtype, (s_max, 1, 0, s_max // 3 + 5),
                seed=len(results))
            got = dk.quantized_flash_decode(q, k, ks, v, vs, bias, block_k=bk)
            torch.cuda.synchronize()
            want = dk.quantized_flash_decode_plain(q, k, ks, v, vs, bias, block_k=bk)
            res = {"case": f"Hq{hq} Hkv{hkv} S{s_max} bk{bk} D{d} Tq{tq} {str(dtype)[6:]}",
                   "relerr": rel_err(got, want), "max_abs": float((got - want).abs().max()),
                   "finite": torch_isfinite(got), "tol": tol}
            res["ok"] = res["finite"] and res["relerr"] <= tol
            results.append(res)

    for hq, hkv in ((HQ, HKV), (HKV, HKV)):
        for s_max, bk in ((SK, 2048), (768, 256)):
            for d in (64, 128, 72, 256):  # 72: rows not 16-byte aligned; 256: the 256 template
                for tq in (1, 4, 16):
                    check(hq, hkv, tq, d, s_max, bk)
    # The cluster's edges: MQA (Hq 16 / Hkv 1: 16 and 256 query rows, the
    # latter in row groups of 32, or 16 at D 256), S_max 64 (five of a
    # cluster's eight splits get no cache row), S_max 1000 in one block_k
    # tile (splits of 128 rows, the last of 104: a partial stage).
    for tq in (1, 16):
        for d in (64, 256):
            check(HQ, 1, tq, d, SK, 2048)
    for s_max, bk in ((64, 64), (1000, 1000)):
        for tq in (1, 16):
            for d in (64, 72):
                check(HQ, HKV, tq, d, s_max, bk)
    worst = {"flash_decode": max(r["max_abs"] for r in results)}
    summary = {"phase": "decode_kernel_check", "cases": len(results),
               "lengths": "S_max, 1, 0, S_max/3 + 5",
               "worst_relerr_fp32": max(r["relerr"] for r in results if "float32" in r["case"]),
               "worst_relerr_bf16": max(r["relerr"] for r in results if "bfloat16" in r["case"]),
               "worst_max_abs": worst["flash_decode"],
               "failed": [r["case"] for r in results if not r["ok"]]}
    emit(summary)
    record["decode_kernel_checks"] = results
    if summary["failed"]:
        raise AssertionError(f"flash_decode disagrees with its plain version: {summary['failed']}")

    # Timing at the serving geometry, full cache, bf16. Before each timing
    # the 50 MB L2 is evicted by reading 256 MB (clean lines, as a decode
    # step leaves it after reading the previous layer's cache), and the card
    # then spins while the host enqueues the timed call, so that the events
    # time the device and not the Python wrapper.
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def flush():
        flush_buf.sum()
        torch.cuda._sleep(1_000_000)

    smem = _kernels.function("flash_decode", "umfa_flash_decode_smem_bytes", (ctypes.c_int,) * 4)
    splits = _kernels.function("flash_decode", "umfa_flash_decode_splits", (ctypes.c_int,) * 7)
    timing = {}
    for tq, d in ((1, D), (16, D), (1, 256)):
        q, k, ks, v, vs, bias, lengths = decode_inputs(
            B_SERVE, HQ, HKV, tq, d, SK, torch.bfloat16, (SK,) * B_SERVE, seed=1000 + tq + d)
        args = (q, k, ks, v, vs, bias)
        got = dk.quantized_flash_decode(*args, block_k=2048)
        again = dk.quantized_flash_decode(*args, block_k=2048)
        want = dk.quantized_flash_decode_plain(*args, block_k=2048)
        cache = QuantizedKVCache(k, ks, v, vs, lengths)
        nbytes = (k.numel() + v.numel() + 4 * (ks.numel() + vs.numel() + bias.numel())
                  + 2 * q.numel() + 4 * got.numel())
        flops = 4 * B_SERVE * HQ * tq * SK * d  # QKᵀ and P·V
        rows = HQ // HKV * tq
        rows_a_block = 32 if rows > 16 and d <= 128 else 16
        t = {
            "shape": f"B{B_SERVE} Hq{HQ} Hkv{HKV} Tq{tq} S{SK} D{d} bf16, full cache",
            "ms": cuda_ms(lambda: dk.quantized_flash_decode(*args, block_k=2048), before=flush),
            "plain_ms": cuda_ms(lambda: dk.quantized_flash_decode_plain(*args, block_k=2048),
                                iters=3, warmup=1, before=flush),
            "gemv_ms": cuda_ms(lambda: _gemv_decode(q, cache, bias, None), before=flush),
            "library_ms": None,  # no single PyTorch call computes INT8-cache decode attention
            "bytes": nbytes, "flops": flops,
            "bytes_ms": nbytes / H100_HBM_BYTES * 1e3, "ops_ms": flops / H100_BF16_FLOPS * 1e3,
            "relerr": rel_err(got, want), "max_abs": float((got - want).abs().max()),
            "finite": torch_isfinite(got), "same_bits_twice": bool(torch.equal(got, again)),
            "cluster": splits(B_SERVE, HKV, rows, tq, SK, d, 1),
            "blocks": splits(B_SERVE, HKV, rows, tq, SK, d, 1) * B_SERVE * HKV
                      * -(-rows // rows_a_block),
            "smem_bytes": smem(d, rows, tq, 1),
        }
        bound(t)
        emit({"phase": "kernel_timing", "kernel": "flash_decode", **t})
        timing[f"tq{tq}_d{d}"] = t
        if not (t["relerr"] <= 1e-2 and t["finite"] and t["same_bits_twice"]):
            raise AssertionError(f"flash_decode at the serving shape: relerr {t['relerr']}, "
                                 f"finite {t['finite']}, same bits twice {t['same_bits_twice']}")
        del args, got, again, want, cache, q, k, ks, v, vs, bias
    del flush_buf
    torch.cuda.empty_cache()
    record["decode_kernel_timing"] = timing
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    t1 = timing[f"tq1_d{D}"]
    out_timing = {"flash_decode": {k2: t1[k2] for k2 in keys}}
    out_timing["flash_decode"]["variants"] = [
        {"shape": timing[name]["shape"], **{k2: timing[name][k2] for k2 in keys + ("relerr",)}}
        for name in (f"tq16_d{D}", "tq1_d256")]
    return out_timing, worst


def one_slot(cache, slot):
    """A one-slot view of a batch cache, starting empty: a prefill through
    it writes from row 0, in place into the batch buffers."""
    import torch

    fields = {f.name: getattr(cache, f.name)[slot:slot + 1] for f in dataclasses.fields(cache)
              if f.name != "length"}
    return type(cache)(**fields, length=torch.zeros((1,), dtype=torch.int32,
                                                    device=cache.length.device))


def run_batching(model, prompts, new_tokens, step_tokens, slots, dev):
    """Serve the requests (prompt i: prompts[i] (1, L_i), max_new_tokens
    new_tokens[i]) through a ContinuousBatcher with `slots` decode lanes:
    each admission prefills its slot, each round decodes the teacher-forced
    tokens step_tokens[round] (slots, 1) for every slot at ragged lengths
    (uniform_pos=False), and slots retired in a round are reset after its
    device step. Raises if a cache length is off; returns the run."""
    import torch

    from umfa_tpu_torch.models import gpt
    from umfa_tpu_torch.serving.scheduler import ContinuousBatcher, reset_slot

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    caches = gpt.init_caches(model.cfg, slots, device=dev)
    batcher = ContinuousBatcher(slots)
    for prompt, n in zip(prompts, new_tokens):
        batcher.submit(prompt.shape[1], n)
    owner, retired, prefill_ms, prefill_logits = {}, [], [], []

    def on_admit(slot, req):
        sync()
        t0 = time.perf_counter()
        logits, _ = gpt.forward_with_cache(model, prompts[req.uid].to(dev),
                                           [one_slot(c, slot) for c in caches], prefill=True)
        for c in caches:
            c.length[slot] = req.prompt_len
        sync()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        prefill_logits.append(logits[0, -1].float().cpu())
        owner[slot] = req

    round_ms, round_logits, finite = [], [], True
    t_start = time.perf_counter()
    while not batcher.idle:
        retired.clear()
        mask = batcher.step(on_admit, lambda slot, req: retired.append(slot))
        tokens = step_tokens[len(round_ms)].to(dev)
        sync()
        t0 = time.perf_counter()
        logits, _ = gpt.forward_with_cache(model, tokens, caches, uniform_pos=False)
        sync()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        lengths = caches[0].length.tolist()
        for slot in range(slots):
            if mask[slot] and lengths[slot] != owner[slot].prompt_len + owner[slot].generated:
                raise AssertionError(
                    f"round {len(round_ms)}: slot {slot} holds {lengths[slot]} rows, expected "
                    f"{owner[slot].prompt_len} + {owner[slot].generated}")
        last = logits[:, -1].float()
        finite = finite and torch_isfinite(last)
        round_logits.append(last[torch.from_numpy(mask).to(dev)].cpu())
        for slot in retired:
            for c in caches:
                reset_slot(c, slot)
    wall_s = time.perf_counter() - t_start
    stats = batcher.stats
    generated = sum(new_tokens)
    return {
        "requests": len(prompts), "slots": slots, "admitted": stats.admitted,
        "completed": stats.completed, "rounds": len(round_ms),
        "mean_occupancy": stats.mean_occupancy,
        "decode_round_ms_median": statistics.median(round_ms),
        "decode_round_ms_sum": sum(round_ms),
        "generated_tokens": generated,
        "generated_tokens_per_s": generated / sum(round_ms) * 1e3,
        "prefill_tokens": sum(p.shape[1] for p in prompts),
        "prefill_ms_per_admission": statistics.mean(prefill_ms),
        "wall_s": wall_s, "logits_finite": finite,
        "round_logits": round_logits, "prefill_logits": prefill_logits,
    }


def batching_requests(n, prompt_range, new_range, slots, vocab, seed):
    """Seeded requests: prompts (1, L) with L in prompt_range, max_new_tokens
    in new_range, and a teacher-forced (slots, 1) token table per round."""
    import torch

    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(prompt_range[0], prompt_range[1] + 1, (n,), generator=g).tolist()
    new = torch.randint(new_range[0], new_range[1] + 1, (n,), generator=g).tolist()
    prompts = [torch.randint(0, vocab, (1, ln), generator=g) for ln in lens]
    steps = torch.randint(0, vocab, (sum(new), slots, 1), generator=g)
    return prompts, new, steps


def phase_continuous_batching(record):
    """The full-width model with the INT8 cache serves 24 requests of
    different prompt lengths through 8 continuously refilled slots, with
    the flash-decode switch on and off (after a warm-up run)."""
    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.models import gpt
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    cfg = gpt.GPTConfig(vocab=32768, dim=1024, num_heads=HQ, num_kv_heads=HKV, depth=8,
                        max_seq=SK, dtype="bfloat16", kv_cache="int8")
    model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    prompts, new, steps = batching_requests(N_REQUESTS, PROMPT_RANGE, NEW_RANGE, SLOTS,
                                            cfg.vocab, seed=21)
    runs, path_counts = {}, []
    for name, switch in (("warmup", "1"), ("on", "1"), ("off", None)):
        if switch:
            os.environ[DECODE_SWITCH] = switch
        try:
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            r = run_batching(model, prompts, new, steps, SLOTS, dev)
            torch.cuda.synchronize()
            counts = dict(_kernels.launches)
        finally:
            os.environ.pop(DECODE_SWITCH, None)
        runs[name] = r
        want = {"quant_attn_fwd": cfg.depth * r["admitted"]}
        if switch:
            want.update(flash_decode=cfg.depth * r["rounds"])
        res = {"phase": "continuous_batching", "run": name, "switch": DECODE_SWITCH + "=1"
               if switch else "unset", "kv_cache": "int8",
               **{k2: v2 for k2, v2 in r.items() if not k2.endswith("logits")},
               "launches": counts}
        emit(res)
        record.setdefault("continuous_batching", []).append(res)
        if not (r["completed"] == r["admitted"] == N_REQUESTS and r["logits_finite"]):
            raise AssertionError(f"continuous batching ({name}): {r['completed']} of "
                                 f"{N_REQUESTS} completed, finite logits {r['logits_finite']}")
        if {k2: v2 for k2, v2 in counts.items() if v2} != want:
            raise AssertionError(f"continuous batching ({name}): launches {counts}, "
                                 f"expected {want}")
        if name != "warmup":
            path_counts.append(counts)
    on, off = runs["on"], runs["off"]
    if on["rounds"] != off["rounds"]:
        raise AssertionError(f"the two runs took {on['rounds']} and {off['rounds']} rounds")
    errs = [rel_err(a, b) for a, b in zip(on["round_logits"], off["round_logits"])]
    agree = {"phase": "continuous_batching_agreement", "rounds": len(errs),
             "worst_round_relerr": max(errs), "median_round_relerr": statistics.median(errs),
             "tol": 2e-2, "compared": "last-position logits of the active slots, switch on vs off"}
    emit(agree)
    record["continuous_batching_agreement"] = agree
    if not max(errs) <= 2e-2:
        raise AssertionError(f"switch on and off disagree: worst round relerr {max(errs)}")
    del model, runs
    torch.cuda.empty_cache()
    return path_counts


def phase_small_batching(record):
    """A small model's continuous-batching loop (4 slots, 8 requests, the
    switch on) on the card against the same loop on the CPU (plain path),
    for the INT8 cache (the flash-decode route, block_k 256: three tiles)
    and the dense cache (the gemv route)."""
    import torch

    from umfa_tpu_torch.models import gpt

    prompts, new, steps = batching_requests(8, (16, 256), (4, 16), 4, 512, seed=22)
    out = {}
    os.environ[DECODE_SWITCH] = "1"
    try:
        for kind, tol in (("int8", 1e-2), ("dtype", 1e-4)):
            cfg = gpt.GPTConfig(vocab=512, dim=256, num_heads=4, num_kv_heads=2, depth=2,
                                max_seq=768, kv_cache=kind)
            runs = {}
            for dev in ("cuda", "cpu"):
                model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
                runs[dev] = run_batching(model, prompts, new, steps, 4, torch.device(dev))
            pairs = (list(zip(runs["cuda"]["round_logits"], runs["cpu"]["round_logits"]))
                     + list(zip(runs["cuda"]["prefill_logits"], runs["cpu"]["prefill_logits"])))
            err = max(float((a - b).abs().max()) for a, b in pairs)
            r = {"phase": "small_batching_vs_cpu", "kv_cache": kind,
                 "rounds": runs["cuda"]["rounds"], "completed": runs["cuda"]["completed"],
                 "max_abs_logits": err, "tol": tol}
            emit(r)
            out[kind] = r
            if runs["cuda"]["rounds"] != runs["cpu"]["rounds"] or not err <= tol:
                raise AssertionError(f"small continuous batching on the card differs from the "
                                     f"CPU: {r}")
    finally:
        os.environ.pop(DECODE_SWITCH, None)
    record["small_batching"] = out


def phase_bwd_kernels(record):
    """Rows 2-4 against their plain versions, then timed at the training
    shape. The forward kernel (checked in phase 3) gives out and lse."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from umfa_tpu_torch.ops import flash_bwd as fb
    from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def inputs(b, sq, sk, d, dtype, bias_shape=None, dlse=False, q_sd=1.0, **kw):
        q, k, v = randn((b, HQ, sq, d), dtype), randn((b, HKV, sk, d), dtype), randn((b, HKV, sk, d), dtype)
        if q_sd != 1.0:
            q = q * q_sd
        bias = None
        if bias_shape is not None:
            bias = randn({"bhqk": (b, HQ, sq, sk), "11qk": (1, 1, sq, sk)}[bias_shape])
            bias = torch.where(bias > 2.0, torch.full_like(bias, -1e30), bias)
        out, lse = flash_attention_forward(q, k, v, bias, **kw)
        do = randn(out.shape, out.dtype)
        return (q, k, v, out, lse, do, bias, randn(lse.shape) if dlse else None)

    cases = [  # name, sq, sk, d, kwargs
        ("causal_1024", 1024, 1024, 64, dict(causal=True)),
        ("odd_777x1000_dlse", 777, 1000, 64, dict(causal=True, dlse=True)),
        ("window_128_0", 1024, 1024, 64, dict(window=(128, 0))),
        ("bias_bhqk_512", 512, 512, 64, dict(bias_shape="bhqk")),
        ("bias_11qk_causal", 1024, 1024, 64, dict(causal=True, bias_shape="11qk")),
        ("masked_rows_1088x1024", 1088, 1024, 64, dict(window=(0, -1))),
        ("d32_causal", 1024, 1024, 32, dict(causal=True)),
        ("d128_causal", 1024, 1024, 128, dict(causal=True)),
    ]
    # fp32: 1e-4 (tests/test_flash_backward.py:32); bf16-emitted: 2e-2
    # (TOL["bf16"]); dbias (fp32 out): 1e-4. bf16 inputs with fp32
    # gradients: 5e-4, at head dims whose softmax scale is not a power of
    # two, where Sᵀ takes bf16(q·scale) and dK the raw Q (a dK from the
    # scaled Q sits at ~1.7e-3; the two sides otherwise differ only by bf16
    # rounding flips of P and dS, ~1e-4).
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    runs = [(name, sq, sk, d, kw, dtype, torch.bfloat16 if dtype == torch.bfloat16 else None,
             tol[dtype]) for name, sq, sk, d, kw in cases for dtype in (torch.float32, torch.bfloat16)]
    runs += [("fp32_grads_d128_causal", 1024, 1024, 128, dict(causal=True), torch.bfloat16, None, 5e-4),
             ("fp32_grads_d80_odd_777x1000_window_dlse", 777, 1000, 80,
              dict(window=(128, 0), dlse=True), torch.bfloat16, None, 5e-4),
             # D 256 (D 192 padded to it): bf16, and fp32 on the wide 3xTF32 tiles
             # (the dbias in 3xTF32 at D 192 and 256 too).
             ("d256_causal_dlse", 1024, 1024, 256, dict(causal=True, dlse=True), torch.bfloat16,
              torch.bfloat16, tol[torch.bfloat16]),
             ("d256_bias_11qk_window_128_0", 777, 1000, 256, dict(window=(128, 0), bias_shape="11qk"),
              torch.bfloat16, torch.bfloat16, tol[torch.bfloat16]),
             ("fp32_grads_d256_causal", 1024, 1024, 256, dict(causal=True), torch.bfloat16, None, 5e-4),
             ("d256_causal_dlse", 1024, 1024, 256, dict(causal=True, dlse=True), torch.float32,
              None, tol[torch.float32]),
             ("d256_bias_11qk_window_128_0", 777, 1000, 256, dict(window=(128, 0), bias_shape="11qk"),
              torch.float32, None, tol[torch.float32]),
             ("d192_masked_rows_1088x1024_dlse", 1088, 1024, 192, dict(window=(0, -1), dlse=True),
              torch.float32, None, tol[torch.float32]),
             ("d192_bias_bhqk_causal_512", 512, 512, 192, dict(causal=True, bias_shape="bhqk"),
              torch.float32, None, tol[torch.float32])]
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0, "flash_dbias": 0.0}
    results = []
    for name, sq, sk, d, kw, dtype, gdt, gate in runs:
        args = inputs(B_CHECK, sq, sk, d, dtype, **kw)
        mask_kw = dict(causal=kw.get("causal", False), window=kw.get("window"))
        got = fb.flash_attention_backward(*args, grad_dtype=gdt, **mask_kw)
        torch.cuda.synchronize()
        want = fb.flash_attention_backward_plain(*args, grad_dtype=gdt, **mask_kw)
        empty = args[4] <= -1e29
        res = {"case": f"flash_bwd/{str(dtype)[6:]}/{name}", "tol": gate,
               "empty_rows": int(empty.sum()),
               "empty_rows_exact": bool((got[0][empty] == 0).all() and (want[0][empty] == 0).all())}
        for kernel, grad, g, w in zip(("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"),
                                      ("dq", "dk", "dv"), got, want):
            res[f"relerr_{grad}"] = rel_err(g, w)
            res[f"max_abs_{grad}"] = float((g.float() - w.float()).abs().max())
            res[f"finite_{grad}"] = torch_isfinite(g.float())
            worst[kernel] = max(worst[kernel], res[f"max_abs_{grad}"])
        res["ok"] = (res["empty_rows_exact"]
                     and all(res[f"relerr_{g}"] <= gate and res[f"finite_{g}"]
                             for g in ("dq", "dk", "dv")))
        results.append(res)
        emit({"phase": "kernel_check", **res})
        bias = args[6]
        if bias is not None:
            q, k, v, out, lse, do = args[:6]
            got = fb.flash_attention_bias_grad(q, k, v, out, lse, do, bias, **mask_kw)
            torch.cuda.synchronize()
            want = fb.flash_attention_bias_grad_plain(q, k, v, out, lse, do, bias, **mask_kw)
            res = {"case": f"flash_dbias/{str(dtype)[6:]}/{name}", "tol": 1e-4,
                   "relerr": rel_err(got, want),
                   "max_abs": float((got - want).abs().max()),
                   "shape_ok": tuple(got.shape) == tuple(bias.shape),
                   "finite": torch_isfinite(got)}
            res["ok"] = res["relerr"] <= 1e-4 and res["shape_ok"] and res["finite"]
            worst["flash_dbias"] = max(worst["flash_dbias"], res["max_abs"])
            results.append(res)
            emit({"phase": "kernel_check", **res})
        del args, got, want
    # The fp32 dQ and dK/dV (3xTF32) against a float64 evaluation of the
    # same function, beside their plain version, at causal S 1024 with
    # q ~ N(0, 3): within 5e-6 of the plain version, as
    # tests/test_torch_kernels_cuda.py test_flash_bwd_fp32_keeps_highest_accuracy.
    for d in (64, 128, 256):
        q, k, v, out, lse, do, _, _ = inputs(B_CHECK, 1024, 1024, d, torch.float32, causal=True,
                                             q_sd=3.0)
        got = fb.flash_attention_backward(q, k, v, out, lse, do, causal=True)
        torch.cuda.synchronize()
        want = fb.flash_attention_backward_plain(q, k, v, out, lse, do, causal=True)
        ref = f64_backward(fb._prepare(q, k, v, out, lse, do, None, None, True, None, None))
        res = {"case": f"flash_bwd/float32/highest_accuracy_d{d}", "tol": 5e-6}
        for grad, g, w, r in zip(("dq", "dk", "dv"), got, want, ref):
            res[f"relerr_{grad}"] = rel_err(g, w)
            res[f"kernel_vs_f64_{grad}"] = rel_err(g, r)
            res[f"plain_vs_f64_{grad}"] = rel_err(w, r)
        res["ok"] = all(res[f"relerr_{g}"] <= 5e-6 for g in ("dq", "dk", "dv"))
        results.append(res)
        emit({"phase": "kernel_check", **res})
        del q, k, v, out, lse, do, got, want, ref
    # The fp32 dbias (3xTF32) at the same shape and gate, a shared bias
    # (summed over batch and heads), as test_flash_dbias_fp32_keeps_highest_accuracy.
    for d in (64, 128, 256):
        q, k, v, out, lse, do, bias, _ = inputs(B_CHECK, 1024, 1024, d, torch.float32,
                                                causal=True, bias_shape="11qk", q_sd=3.0)
        got = fb.flash_attention_bias_grad(q, k, v, out, lse, do, bias, causal=True)
        torch.cuda.synchronize()
        want = fb.flash_attention_bias_grad_plain(q, k, v, out, lse, do, bias, causal=True)
        res = {"case": f"flash_dbias/float32/highest_accuracy_d{d}", "tol": 5e-6,
               "relerr": rel_err(got, want), "max_abs": float((got - want).abs().max())}
        res["ok"] = res["relerr"] <= 5e-6 and torch_isfinite(got)
        worst["flash_dbias"] = max(worst["flash_dbias"], res["max_abs"])
        results.append(res)
        emit({"phase": "kernel_check", **res})
        del q, k, v, out, lse, do, bias, got, want
    record["bwd_kernel_checks"] = results
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"backward kernels disagree with their plain versions: {bad}")

    # Timing at the training shape: B8 Hq16 Hkv8 Sq = Sk = 4096 D64 causal bf16.
    torch.cuda.empty_cache()
    b, s = B_TRAIN, S_TRAIN
    shape = f"B{b} Hq{HQ} Hkv{HKV} Sq{s} Sk{s} D{D} causal bf16"
    q, k, v = randn((b, HQ, s, D), torch.bfloat16), randn((b, HKV, s, D), torch.bfloat16), randn((b, HKV, s, D), torch.bfloat16)
    out, lse = flash_attention_forward(q, k, v, causal=True)
    do = randn(out.shape, torch.bfloat16)
    p = fb._prepare(q, k, v, out, lse, do, None, None, True, None, None)
    pairs = b * HQ * visible_pairs(s, s, -1, 0)
    reads = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 4 * 2 * lse.numel()  # + lse, delta
    timing = {}
    passes = {  # kernel: (launch, plain, products, bytes written, grads)
        "flash_bwd_dq": (lambda: (fb._launch_dq(p, torch.bfloat16),), lambda: (fb._plain_dq(p),),
                         3, 2 * q.numel(), ("dq",)),
        "flash_bwd_dkv": (lambda: fb._launch_dkv(p, torch.bfloat16), lambda: fb._plain_dkv(p),
                          4, 2 * 2 * k.numel(), ("dk", "dv")),
    }
    for name, (kern, plain, products, written, grads) in passes.items():
        got, want = kern(), plain()
        check = {g: rel_err(x, y) for g, x, y in zip(grads, got, want)}
        worst[name] = max(worst[name], *(float((x.float() - y.float()).abs().max())
                                         for x, y in zip(got, want)))
        del got, want
        flops = 2 * D * products * pairs
        nbytes = reads + written
        timing[name] = dict(**cuda_stats(kern), plain_ms=cuda_ms(plain, iters=3, warmup=1),
                            flops=flops, bytes=nbytes, ops_ms=flops / H100_BF16_FLOPS * 1e3,
                            bytes_ms=nbytes / H100_HBM_BYTES * 1e3, check=check,
                            ok=all(e <= 2e-2 for e in check.values()))
        torch.cuda.empty_cache()

    # Yardstick: the flash SDPA backward at the same shape (dQ, dK, dV in one call).
    qg = q.detach().requires_grad_(True)
    try:
        kg, vg = k.detach().requires_grad_(True), v.detach().requires_grad_(True)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        sdpa_gqa = "enable_gqa"
    except (RuntimeError, TypeError):
        kg = k.repeat_interleave(HQ // HKV, 1).requires_grad_(True)
        vg = v.repeat_interleave(HQ // HKV, 1).requires_grad_(True)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        sdpa_gqa = "K and V expanded to 16 heads (this torch refused enable_gqa)"
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True))
    for name in passes:
        timing[name].update(library_ms=sdpa_bwd_ms,
                            library="flash SDPA backward (dQ, dK and dV in one call), " + sdpa_gqa)
    del qg, kg, vg, o
    torch.cuda.empty_cache()

    # The fp32 dense backward (the int8-qdense recipe runs it): the same
    # kernels on fp32 inputs, 3xTF32 on the tensor cores, against the
    # memory-efficient SDPA backward on the same fp32 inputs. Bound: the
    # 3xTF32 floor (three TF32 products for each fp32 one at the TF32 peak),
    # with the fp32 CUDA-core time of the same flop beside it.
    # At D 64 (the bf16 inputs as fp32) and at D 256 (fresh fp32 inputs: the
    # wide 3xTF32 tiles).
    shapes = {}
    for suffix, d in (("_fp32", D), ("_fp32_d256", 256)):
        if d == D:
            q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
        else:
            q32, k32, v32 = (randn((b, h, s, d)) for h in (HQ, HKV, HKV))
            do32 = randn((b, HQ, s, d))
        out32, lse32 = flash_attention_forward(q32, k32, v32, causal=True)
        p32 = fb._prepare(q32, k32, v32, out32, lse32, do32, None, None, True, None, None)
        reads32 = 4 * (q32.numel() + k32.numel() + v32.numel() + do32.numel() + 2 * lse32.numel())
        passes32 = {
            "flash_bwd_dq" + suffix: (lambda: (fb._launch_dq(p32, torch.float32),),
                                      lambda: (fb._plain_dq(p32),), 3, 4 * q32.numel(), ("dq",)),
            "flash_bwd_dkv" + suffix: (lambda: fb._launch_dkv(p32, torch.float32),
                                       lambda: fb._plain_dkv(p32), 4, 2 * 4 * k32.numel(),
                                       ("dk", "dv")),
        }
        for name, (kern, plain, products, written, grads) in passes32.items():
            got, want = kern(), plain()
            check = {g: rel_err(x, y) for g, x, y in zip(grads, got, want)}
            kernel = name.removesuffix(suffix)
            worst[kernel] = max(worst[kernel],
                                *(float((x - y).abs().max()) for x, y in zip(got, want)))
            del got, want
            flops = 2 * d * products * pairs
            nbytes = reads32 + written
            t = dict(**cuda_stats(kern), plain_ms=cuda_ms(plain, iters=3, warmup=1),
                     flops=flops, bytes=nbytes, ops_ms=3 * flops / H100_TF32_FLOPS * 1e3,
                     bytes_ms=nbytes / H100_HBM_BYTES * 1e3, check=check,
                     ok=all(e <= 1e-4 for e in check.values()))
            t["tf32x3_floor_ms"] = t["ops_ms"]
            t["share_of_tf32x3_floor"] = t["tf32x3_floor_ms"] / t["ms"]
            t["fp32_cuda_core_ms"] = flops / H100_FP32_FLOPS * 1e3
            timing[name] = t
            shapes[name] = f"B{b} Hq{HQ} Hkv{HKV} Sq{s} Sk{s} D{d} causal fp32"
            torch.cuda.empty_cache()
        qg = q32.detach().requires_grad_(True)

        def sdpa32_grads(kg, vg, qg=qg, do32=do32, **kw):
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, **kw)
            torch.autograd.grad(o, (qg, kg, vg), do32, retain_graph=True)
            return lambda: torch.autograd.grad(o, (qg, kg, vg), do32, retain_graph=True)

        try:
            kg, vg = k32.detach().requires_grad_(True), v32.detach().requires_grad_(True)
            grads32 = sdpa32_grads(kg, vg, enable_gqa=True)
            sdpa_gqa = "enable_gqa"
        except (RuntimeError, TypeError):
            kg = k32.repeat_interleave(HQ // HKV, 1).requires_grad_(True)
            vg = v32.repeat_interleave(HQ // HKV, 1).requires_grad_(True)
            grads32 = sdpa32_grads(kg, vg)
            sdpa_gqa = "K and V expanded to 16 heads outside the timing (enable_gqa refused)"
        sdpa32_ms = cuda_ms(grads32)
        for name in passes32:
            timing[name].update(library_ms=sdpa32_ms,
                                library="memory-efficient SDPA backward on the fp32 inputs (dQ, "
                                        "dK and dV in one call), " + sdpa_gqa)
        del qg, kg, vg, grads32, p32, q32, k32, v32, do32, out32, lse32, passes32
        torch.cuda.empty_cache()

    # dbias with a (1, Hq, S, S) bias, summed over the batch in the kernel.
    bias = torch.randn((1, HQ, s, s), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(8))
    out_b, lse_b = flash_attention_forward(q, k, v, bias, causal=True)
    pb = fb._prepare(q, k, v, out_b, lse_b, do, bias, None, True, None, None)
    kern = lambda: fb._launch_dbias(pb, tuple(bias.shape))  # noqa: E731
    plain = lambda: fb._plain_dbias(pb, tuple(bias.shape))  # noqa: E731
    got, want = kern(), plain()
    check = {"dbias": rel_err(got, want)}
    worst["flash_dbias"] = max(worst["flash_dbias"], float((got - want).abs().max()))
    del got, want
    torch.cuda.empty_cache()
    flops = 2 * D * 2 * pairs
    nbytes = reads + 4 * HQ * visible_pairs(s, s, -1, 0) + 4 * bias.numel()  # visible bias read, dbias written
    timing["flash_dbias"] = dict(**cuda_stats(kern), plain_ms=cuda_ms(plain, iters=3, warmup=1),
                                 flops=flops, bytes=nbytes, ops_ms=flops / H100_BF16_FLOPS * 1e3,
                                 bytes_ms=nbytes / H100_HBM_BYTES * 1e3, check=check,
                                 ok=check["dbias"] <= 1e-4)
    torch.cuda.empty_cache()
    # Yardstick: the memory-efficient SDPA backward with a bias that requires
    # grad (causal folded into the bf16 bias; it also computes dQ, dK, dV).
    vis = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    mask = torch.where(vis, bias, float("-inf")).to(torch.bfloat16).requires_grad_(True)
    qg = q.detach().requires_grad_(True)
    kx = k.repeat_interleave(HQ // HKV, 1).requires_grad_(True)
    vx = v.repeat_interleave(HQ // HKV, 1).requires_grad_(True)
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            o = F.scaled_dot_product_attention(qg, kx, vx, attn_mask=mask)
        timing["flash_dbias"]["library_ms"] = cuda_ms(
            lambda: torch.autograd.grad(o, (mask,), do, retain_graph=True))
        timing["flash_dbias"]["library"] = ("memory-efficient SDPA backward with a (1, 16, S, S) "
                                             "bf16 bias gradient; also computes dQ, dK, dV")
        del o
    except RuntimeError as e:
        timing["flash_dbias"]["library_ms"] = None
        timing["flash_dbias"]["library"] = f"none: this torch refused the bias gradient ({e})"[:300]
    del qg, kx, vx, mask, pb, out_b, lse_b
    torch.cuda.empty_cache()

    # dbias on fp32 inputs (3xTF32 on the tensor cores) with the same bias,
    # at D 64 and 256. Bound: the 3xTF32 floor, as the fp32 dQ and dK/dV;
    # yardstick: the memory-efficient SDPA backward with an fp32 bias
    # gradient.
    del q, k, v, do, out, lse, p
    torch.cuda.empty_cache()
    for d in (D, 256):
        q32, k32, v32 = (randn(shape) for shape in ((b, HQ, s, d), (b, HKV, s, d), (b, HKV, s, d)))
        do32 = randn((b, HQ, s, d))
        out_b, lse_b = flash_attention_forward(q32, k32, v32, bias, causal=True)
        pb = fb._prepare(q32, k32, v32, out_b, lse_b, do32, bias, None, True, None, None)
        kern = lambda: fb._launch_dbias(pb, tuple(bias.shape))  # noqa: E731
        plain = lambda: fb._plain_dbias(pb, tuple(bias.shape))  # noqa: E731
        got, want = kern(), plain()
        check = {"dbias": rel_err(got, want)}
        worst["flash_dbias"] = max(worst["flash_dbias"], float((got - want).abs().max()))
        del got, want
        torch.cuda.empty_cache()
        flops = 2 * d * 2 * pairs
        reads32 = 4 * (q32.numel() + k32.numel() + v32.numel() + do32.numel()) + 4 * 2 * lse_b.numel()
        nbytes = reads32 + 4 * HQ * visible_pairs(s, s, -1, 0) + 4 * bias.numel()
        t = dict(**cuda_stats(kern, iters=5, warmup=1), plain_ms=cuda_ms(plain, iters=3, warmup=1),
                 flops=flops, bytes=nbytes, ops_ms=3 * flops / H100_TF32_FLOPS * 1e3,
                 bytes_ms=nbytes / H100_HBM_BYTES * 1e3, check=check, ok=check["dbias"] <= 1e-4)
        t["tf32x3_floor_ms"] = t["ops_ms"]
        t["fp32_cuda_core_ms"] = flops / H100_FP32_FLOPS * 1e3
        mask = torch.where(vis, bias, float("-inf")).requires_grad_(True)
        qg = q32.detach().requires_grad_(True)
        kx = k32.repeat_interleave(HQ // HKV, 1).requires_grad_(True)
        vx = v32.repeat_interleave(HQ // HKV, 1).requires_grad_(True)
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o = F.scaled_dot_product_attention(qg, kx, vx, attn_mask=mask)
            t["library_ms"] = cuda_ms(lambda: torch.autograd.grad(o, (mask,), do32, retain_graph=True))
            t["library"] = ("memory-efficient SDPA backward with a (1, 16, S, S) fp32 bias gradient "
                            "on the fp32 inputs; also computes dQ, dK, dV")
            del o
        except RuntimeError as e:
            t["library_ms"] = None
            t["library"] = f"none: this torch refused the fp32 bias gradient ({e})"[:300]
        key = "flash_dbias_fp32" if d == D else f"flash_dbias_fp32_d{d}"
        timing[key] = t
        shapes[key] = f"B{b} Hq{HQ} Hkv{HKV} Sq{s} Sk{s} D{d} causal fp32, bias (1, {HQ}, S, S)"
        del qg, kx, vx, mask, pb, q32, k32, v32, do32, out_b, lse_b
        torch.cuda.empty_cache()
    del bias, vis
    torch.cuda.empty_cache()

    for name, t in timing.items():
        if not t["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version at the training shape: {t['check']}")
        bound(t)
        emit({"phase": "kernel_timing", "kernel": name,
              "shape": shapes.get(name, shape.replace("bf16", "fp32") if name.endswith("_fp32")
                                  else shape), **t})
    record["bwd_kernel_timing"] = timing
    timing["flash_dbias"]["variants"] = [
        {"shape": shapes[key], **{k2: timing[key][k2] for k2 in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tf32x3_floor_ms")}}
        for key in ("flash_dbias_fp32", "flash_dbias_fp32_d256")]
    return timing, worst


def f64_backward(p):
    """dQ, dK, dV of a prepared fp32 backward (ops/flash_bwd.py `_Prepared`,
    causal, no bias) evaluated in float64: the same function as the
    kernels and their plain version, rounded nowhere."""
    import torch

    from umfa_tpu_torch.ops.flash_bwd import _kernel_lse

    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    g = hq // hkv
    q, do = p.q.double(), p.do.double()
    k, v = (x.double().repeat_interleave(g, 1) for x in (p.k, p.v))
    hidden = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril().logical_not()
    pm = torch.exp((q * p.scale) @ k.transpose(-1, -2) - _kernel_lse(p.lse).double()[..., None])
    pm = pm.masked_fill(hidden, 0.0)
    ds = pm * (do @ v.transpose(-1, -2) - p.delta.double()[..., None])
    dk = (p.scale * ds.transpose(-1, -2) @ q).reshape(b, hkv, g, sk, d).sum(2)
    dv = (pm.transpose(-1, -2) @ do).reshape(b, hkv, g, sk, d).sum(2)
    return p.scale * ds @ k, dk, dv


def loss_fn(model, tokens):
    """Next-token cross-entropy in fp32 (tests/test_gpt.py:31-37)."""
    import torch

    logits = model(tokens[:, :-1]).float()
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(-1, tokens[:, 1:, None]).mean()


def sgd_steps(phase, model, loss_of, want, lr, tokens):
    """One warm-up and three timed steps of loss_of(), `.backward()` and
    plain SGD on `model`'s parameters: each with a finite loss below the step
    before's and exactly the launches `want`; forward, backward and SGD ms
    and peak memory. Returns (steps, the timed steps' launch counts)."""
    import torch

    from umfa_tpu_torch import _kernels

    steps, path_counts = [], []
    for i in range(4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss = loss_of()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            for prm in model.parameters():
                prm -= lr * prm.grad
                prm.grad = None
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = {key: n for key, n in _kernels.launches.items() if n}
        step = {"phase": phase, "step": i, "warmup": i == 0, "loss": loss.item(), "lr": lr,
                "fwd_ms": (t1 - t0) * 1e3, "bwd_ms": (t2 - t1) * 1e3, "sgd_ms": (t3 - t2) * 1e3,
                "step_ms": (t3 - t0) * 1e3, "tokens_per_s": tokens / (t3 - t0),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts}
        del loss
        emit(step)
        steps.append(step)
        if i > 0:
            path_counts.append(counts)
        if not math.isfinite(step["loss"]) or (i > 0 and not step["loss"] < steps[i - 1]["loss"]):
            raise AssertionError(f"{phase} step {i}: loss {step['loss']} is not finite and "
                                 f"below the step before's")
        if {k: counts.get(k, 0) for k in want} != want:
            raise AssertionError(f"{phase} step {i}: launches {counts}, expected {want}")
    return steps, path_counts


def phase_training(record):
    """The full-width model trains: loss, .backward(), plain SGD."""
    import torch

    from umfa_tpu_torch.models import gpt

    dev = torch.device("cuda")
    cfg = gpt.GPTConfig(vocab=32768, dim=1024, num_heads=HQ, num_kv_heads=HKV, depth=8,
                        max_seq=SK, dtype="bfloat16")
    model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab, (B_TRAIN, S_TRAIN + 1),
                           generator=torch.Generator().manual_seed(5)).to(dev)
    want = {"flash_fwd": cfg.depth, "flash_bwd_dq": cfg.depth, "flash_bwd_dkv": cfg.depth,
            "flash_dbias": 0, "quant_attn_fwd": 0}
    steps, path_counts = sgd_steps("training", model, lambda: loss_fn(model, tokens), want,
                                   TRAIN_LR, B_TRAIN * S_TRAIN)
    record["training"] = {"config": dataclasses.asdict(cfg),
                          "batch": B_TRAIN, "seq": S_TRAIN, "lr": TRAIN_LR, "steps": steps}
    del model, tokens
    torch.cuda.empty_cache()
    return path_counts


def phase_small_training(record):
    """A small fp32 model's loss and every gradient, on the card against the
    plain path on the CPU (the CPU path is held against the JAX package by
    tests/test_torch_gpt_train.py)."""
    import torch

    from umfa_tpu_torch.models import gpt
    from umfa_tpu_torch.utils.testing import rel_err

    cfg = gpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2, max_seq=96)
    tokens = torch.randint(0, 64, (2, 97), generator=torch.Generator().manual_seed(6))
    res = {}
    for dev in ("cuda", "cpu"):
        model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
        loss = loss_fn(model, tokens.to(dev))
        loss.backward()
        res[dev] = (loss.item(), {n: prm.grad.cpu() for n, prm in model.named_parameters()})
    errs = {n: rel_err(res["cuda"][1][n], g) for n, g in res["cpu"][1].items()}
    out = {"phase": "small_training_vs_cpu", "loss_cuda": res["cuda"][0], "loss_cpu": res["cpu"][0],
           "grads": len(errs), "worst_grad_relerr": max(errs.values()), "tol": 1e-4}
    emit(out)
    record["small_training"] = out | {"grad_relerr": errs}
    if not (abs(out["loss_cuda"] - out["loss_cpu"]) <= 1e-4 and out["worst_grad_relerr"] <= 1e-4):
        raise AssertionError(f"small training on the card differs from the CPU path: {out}")


def phase_attention_api(record):
    """attention() with gradients on the card against the CPU path."""
    import torch

    import umfa_tpu_torch as ut
    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.utils.testing import rel_err

    gen = torch.Generator().manual_seed(7)
    b, s = B_CHECK, 1024
    q, k, v = (torch.randn(shape, generator=gen) for shape in
               ((b, HQ, s, D), (b, HKV, s, D), (b, HKV, s, D)))
    bias = torch.randn((1, HQ, s, s), generator=gen)
    bool_mask = torch.rand((1, 1, s, s), generator=gen) > 0.2
    w = torch.randn((b, HQ, s, D), generator=gen)
    calls = [  # name, mask, bias_grad
        ("float_bias_grad", bias, True),
        ("bool_mask", bool_mask, False),
        ("float_bias_no_grad", bias, False),
    ]
    grads = {}
    for dev in ("cuda", "cpu"):
        ut.reset_dispatch_stats()
        _kernels.reset_launch_counts()
        for name, mask, bias_grad in calls:
            # Fresh leaves per call (copy=True: .to() would hand back the
            # CPU tensors themselves, whose .grad would then accumulate).
            t = [x.to(dev, copy=True).requires_grad_(True) for x in (q, k, v)]
            m = mask.to(dev, copy=True).requires_grad_(mask.is_floating_point())
            out = ut.attention(*t, m, bias_grad=bias_grad)
            (out * w.to(dev)).sum().backward()
            grads[dev, name] = [x.grad.cpu() for x in t] + ([m.grad.cpu()] if m.requires_grad else [])
        if dev == "cuda":
            torch.cuda.synchronize()
            counts, stats = dict(_kernels.launches), ut.get_dispatch_stats()
    checks = {}
    for name, _, _ in calls:
        for g, a, c in zip(("dq", "dk", "dv", "dbias"), grads["cuda", name], grads["cpu", name]):
            checks[f"{name}/{g}"] = rel_err(a, c)
    zeros_ok = bool((grads["cuda", "float_bias_no_grad"][3] == 0).all())
    out = {"phase": "attention_api", "shape": f"B{b} Hq{HQ} Hkv{HKV} S{s} D{D} fp32",
           "relerr": checks, "tol": 1e-4, "bias_grad_false_zeros": zeros_ok,
           "launches": counts, "dispatch": stats}
    emit(out)
    record["attention_api"] = out
    if not (all(e <= 1e-4 for e in checks.values()) and zeros_ok):
        raise AssertionError(f"attention() on the card differs from the CPU path: {checks}")
    if stats["fused_autograd"] != len(calls) or stats["naive_fallback"] != 0:
        raise AssertionError(f"attention() took another route than fused_autograd: {stats}")
    if counts.get("flash_dbias", 0) < 1 or counts.get("flash_bwd_dq", 0) != len(calls):
        raise AssertionError(f"attention() did not go through the backward kernels: {counts}")
    return counts


def doc_ids(b, s, lengths, seed, pad=0):
    """(B, S) int32 ids of packed documents, lengths drawn per row from
    [lengths[0], lengths[1]] (a seeded generator), the last `pad` ids -1."""
    import torch

    g = torch.Generator().manual_seed(seed)
    ids = torch.zeros((b, s), dtype=torch.int32)
    for r in range(b):
        pos, doc = 0, 0
        while pos < s:
            n = int(torch.randint(lengths[0], lengths[1] + 1, (1,), generator=g))
            ids[r, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
        if pad:
            ids[r, s - pad:] = -1
    return ids


def sparse_check_mask(kind, b, sq, sk, dev):
    """The BlockMasks of the walked-kernel checks (phase 7a)."""
    import torch

    from umfa_tpu_torch.ops import block_mask as bm
    from umfa_tpu_torch.ops.flash_fwd import BlockSizes

    ids = doc_ids(b, sk, (48, sk // 3), 5, pad=sk // 7)
    if kind == "causal":
        return bm.causal_block_mask(sq, sk, device=dev)
    if kind == "window_128_0":
        return bm.sliding_window_block_mask(sq, sk, 128, 0, device=dev)
    if kind == "segments_padded":
        return bm.segment_block_mask(ids[:, :sq], ids, causal=True, device=dev)
    if kind == "segments_left_padded":
        # Batch 0's -1 ids first, more than a 128-row tile of them: its
        # first fill, and so its K/V means window, is key tile 1, not 0.
        ids[0] = ids[0].flip(0)
        return bm.segment_block_mask(ids[:, :sq], ids, causal=True, device=dev,
                                     block_sizes=BlockSizes(128, 128))
    if kind == "blocks_96x160":
        return bm.segment_block_mask(ids[:, :sq], ids, causal=True, device=dev,
                                     block_sizes=BlockSizes(96, 160))
    if kind == "per_head":
        i, j = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
        heads = torch.stack([(j <= i) & (j >= i - 48 * (h + 1)) for h in range(HQ)])[None]
        return bm.make_block_mask(heads, sq, sk, device=dev)
    if kind == "aligned_no_bias":
        ids = torch.arange(sk, dtype=torch.int32)[None].repeat(b, 1) // 512
        return bm.segment_block_mask(ids[:, :sq], ids, device=dev)
    raise ValueError(kind)


def causal_doc_pairs(ids):
    """Visible (query, key) pairs of a causal segment mask, per batch row
    summed: each document of length L holds L (L + 1) / 2; id -1 none."""
    total = 0
    for row in ids.tolist():
        run, prev = 0, None
        for x in row + [None]:
            if x == prev:
                run += 1
                continue
            if prev is not None and prev >= 0:
                total += run * (run + 1) // 2
            prev, run = x, 1
    return total


def phase_block_sparse(record):
    """Block-sparse masks (ops/block_mask.py) through the walked kernels:
    (a) each walked kernel against its plain version; (b) the full-width
    path, `attention(q, k, v, mask)` with `.backward()` for three masks,
    with exact launches, the plain versions, timings, bounds and the walked
    share; (c) the reference's masks cell."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import umfa_tpu_torch as ut
    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.ops import flash_bwd as fb
    from umfa_tpu_torch.ops import flash_fwd as ff
    from umfa_tpu_torch.ops.block_mask import PARTIAL
    from umfa_tpu_torch.utils.testing import lse_check, rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(21)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    # (a) Walked kernels against their plain versions, B2 Hq16 Hkv8.
    masks = ("causal", "window_128_0", "segments_padded", "per_head", "blocks_96x160",
             "aligned_no_bias")
    cases = [(m, 1024, 1024, 64) for m in masks] + [
        ("segments_padded", 777, 1000, 64), ("blocks_96x160", 777, 1000, 64),
        ("segments_padded", 1024, 1024, 128), ("per_head", 777, 1000, 128),
        ("segments_padded", 1024, 1024, 256), ("blocks_96x160", 777, 1000, 256),
        ("per_head", 1024, 1024, 256)]
    # (out relerr, LSE abs, gradient relerr): the table's gates, as the card
    # tests hold them. At D < 128 the row sum adds bf16(P), as the
    # reference's ones column does, so where P is rounded moves the LSE: the
    # walked forward's pre-pass takes a row's last walked tiles (its own
    # document's keys), so a row that sees few keys rounds P against its
    # final max, as the plain version does. A row whose LSE is past its gate
    # must be within it of the float64 LSE (`lse_check`): in a row of two
    # keys the fp32 plain version can round the second P one ulp off, 1.35e-3
    # in LSE, where the walked and the dense kernels hold the float64 value.
    gates = {torch.float32: (2e-5, 1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-3, 2e-2)}
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    checks = []
    for kind, sq, sk, d in cases:
        mask = sparse_check_mask(kind, B_CHECK, sq, sk, dev)
        walk = dict(block_map=mask.block_map, block_q=mask.block_q, block_k=mask.block_k)
        keep = ff.walked_keys(mask.walk(), sq, sk)
        for dtype in (torch.float32, torch.bfloat16):
            fgate, lgate, bgate = gates[dtype]
            q, k, v = (randn((B_CHECK, h, s, d), dtype) for h, s in ((HQ, sq), (HKV, sk), (HKV, sk)))
            got = ff.flash_attention_forward(q, k, v, mask.bias, fetch_ids=mask.fetch_kv, **walk)
            torch.cuda.synchronize()
            want = ff.flash_attention_forward_plain(q, k, v, mask.bias, **walk)
            res = compare(f"block_sparse/{str(dtype)[6:]}/{kind}_{sq}x{sk}_d{d}", got, want,
                          fgate, lgate)
            res.update(lse_check(got[1], want[1], q, k, mask.bias, lgate, keep=keep))
            if res["lse_rows_over_tol"]:
                # A second reading: the dense kernel (the same bias, no walk)
                # on the same inputs against the same plain version.
                dense = ff.flash_attention_forward(q, k, v, mask.bias)
                dres = lse_check(dense[1], want[1], q, k, mask.bias, lgate, keep=keep)
                res.update({f"dense_{key}": dres[key] for key in
                            ("max_abs_lse", "lse_rows_over_tol", "max_abs_lse_f64_on_those_rows")})
                del dense
            res["ok"] = (res["relerr_out"] <= fgate and res["lse_ok"] and res["empty_rows_exact"]
                         and res["finite"])
            # Rows whose walked keys all carry the -1e30 bias: V averaged
            # over exactly those keys, held to the same gate.
            blind = (want[1] <= -1e29) & (want[0].float() != 0).any(dim=-1)
            res["bias_masked_rows"] = int(blind.sum())
            res["relerr_bias_masked_rows"] = (rel_err(got[0][blind], want[0][blind])
                                              if blind.any() else 0.0)
            res["ok"] = res["ok"] and res["relerr_bias_masked_rows"] <= fgate
            worst["flash_fwd"] = max(worst["flash_fwd"], res["max_abs_out"])
            do = randn(want[0].shape, want[0].dtype)
            dlse = torch.where(want[1] > -1e29, randn(want[1].shape, torch.float32), 0.0)
            gdt = torch.bfloat16 if dtype == torch.bfloat16 else None
            args = (q, k, v, want[0], want[1], do, mask.bias, dlse)
            bgot = fb.flash_attention_backward(*args, grad_dtype=gdt, fetch_kv=mask.fetch_kv,
                                               fetch_q=mask.fetch_q, **walk)
            torch.cuda.synchronize()
            bwant = fb.flash_attention_backward_plain(*args, grad_dtype=gdt, **walk)
            for kern, name, x, y in zip(("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"),
                                        ("dq", "dk", "dv"), bgot, bwant):
                res[f"relerr_{name}"] = rel_err(x, y)
                res["ok"] = res["ok"] and res[f"relerr_{name}"] <= bgate and torch_isfinite(x.float())
                worst[kern] = max(worst[kern], float((x.float() - y.float()).abs().max()))
            res.update(tol_bwd=bgate, block_q=mask.block_q, block_k=mask.block_k,
                       map_shape=list(mask.block_map.shape), bias=mask.bias is not None,
                       sparsity=mask.sparsity)
            emit({"phase": "kernel_check", **res})
            checks.append(res)
            del q, k, v, got, want, do, dlse, args, bgot, bwant
        del mask, keep
    torch.cuda.empty_cache()
    record["block_sparse_checks"] = checks
    bad = [r["case"] for r in checks if not r["ok"]]
    if bad:
        raise AssertionError(f"walked kernels disagree with their plain versions: {bad}")

    # (b) The full-width path: the GPT's attention geometry, bf16.
    b, s = B_TRAIN, S_TRAIN
    shape = f"B{b} Hq{HQ} Hkv{HKV} S{s} D{D} bf16"
    q, k, v = (randn((b, h, s, D), torch.bfloat16) for h in (HQ, HKV, HKV))
    w = randn((b, HQ, s, D), torch.bfloat16)
    docs = doc_ids(b, s, (64, 1536), 8, pad=200)
    full_masks = {  # name: (BlockMask, visible pairs of one head summed over the batch)
        "causal_docs_512": (ut.segment_block_mask(torch.arange(s, dtype=torch.int32)[None] // 512,
                                                  causal=True, device=dev),
                            b * (s // 512) * 512 * 513 // 2),
        "causal_docs_64_1536_padded": (ut.segment_block_mask(docs, causal=True, device=dev),
                                       causal_doc_pairs(docs)),
        "window_512_0": (ut.sliding_window_block_mask(s, s, 512, 0, device=dev),
                         b * visible_pairs(s, s, 512, 0)),
    }
    causal_pairs = b * visible_pairs(s, s, -1, 0)
    reads = 2 * (q.numel() + k.numel() + v.numel())
    pb_dense = None
    timing, counts_all, runs = {}, [], {}
    for name, (mask, pairs1) in full_masks.items():
        # One attention() forward and backward, its launches counted alone.
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        ut.reset_dispatch_stats()
        out = ut.attention(qg, kg, vg, mask)
        out.backward(w)
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
        counts_all.append(counts)
        want_counts = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "flash_dbias": 0}
        if {kk: counts.get(kk, 0) for kk in want_counts} != want_counts:
            raise AssertionError(f"block-sparse {name}: launches {counts}, expected {want_counts}")
        if ut.get_dispatch_stats()["fused_autograd"] != 1:
            raise AssertionError(f"block-sparse {name}: another route than fused_autograd")
        walk = dict(block_map=mask.block_map, block_q=mask.block_q, block_k=mask.block_k)
        pw = ff.flash_attention_forward_plain(q, k, v, mask.bias, **walk)
        res = {"mask": name, "shape": shape, "block_q": mask.block_q, "block_k": mask.block_k,
               "map_shape": list(mask.block_map.shape), "bias": mask.bias is not None,
               "sparsity": mask.sparsity, "launches": counts,
               "relerr_out": rel_err(out, pw[0])}
        grads = fb.flash_attention_backward_plain(q, k, v, pw[0], pw[1], w, mask.bias,
                                                  grad_dtype=torch.bfloat16, **walk)
        for gname, x, y in zip(("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad), grads):
            res[f"relerr_{gname}"] = rel_err(x, y)
        res["ok"] = (res["relerr_out"] <= 1e-2 and torch_isfinite(out.float())
                     and all(res[f"relerr_{g}"] <= 2e-2 for g in ("dq", "dk", "dv")))
        del qg, kg, vg, out, grads, pw
        torch.cuda.empty_cache()
        # Walked share: the (query, key) pairs of the map's walked tiles, each
        # walked in full (no causal flag: the mask's bias hides the upper
        # triangle of a diagonal tile), against the dense causal walk's; the
        # mask's visible pairs for the bound, and the bias where a walked
        # tile is PARTIAL.
        walked = ff.walked_keys(ff.Walk(mask.block_map, None, None, mask.block_q, mask.block_k),
                                s, s)
        walked_pairs = int(walked.sum()) * (b if walked.shape[0] == 1 else 1)
        partial = (mask.block_map == PARTIAL).repeat_interleave(mask.block_q, 2)[:, :, :s] \
            .repeat_interleave(mask.block_k, 3)[..., :s]
        bias_bytes = 4 * int(partial.sum()) if mask.bias is not None else 0
        del walked, partial
        pairs = HQ * pairs1
        res.update(visible_pairs=pairs, walked_pairs=HQ * walked_pairs,
                   walked_share_of_causal=walked_pairs / causal_pairs,
                   visible_share_of_causal=pairs1 / causal_pairs, bias_bytes_read=bias_bytes)
        # Each kernel timed on its own inputs, beside the dense causal kernels.
        p = ff._prepare(q, k, v, mask.bias, False, None, None, None, mask.walk())
        out, lse = ff._launch(p)
        pb = fb._prepare(q, k, v, out, lse, w, mask.bias, None, False, None, None, mask.walk())
        if pb_dense is None:
            od, ld = ff.flash_attention_forward(q, k, v, causal=True)
            pb_dense = fb._prepare(q, k, v, od, ld, w, None, None, True, None, None)
            pf_dense = ff._prepare(q, k, v, None, True, None, None, None)
            dense = {"flash_fwd": cuda_stats(lambda: ff._launch(pf_dense)),
                     "flash_bwd_dq": cuda_stats(lambda: fb._launch_dq(pb_dense, torch.bfloat16)),
                     "flash_bwd_dkv": cuda_stats(lambda: fb._launch_dkv(pb_dense, torch.bfloat16))}
            del od, ld
        kern = {"flash_fwd": (lambda: ff._launch(p), 4, 2 * q.numel() + 4 * lse.numel()),
                "flash_bwd_dq": (lambda: fb._launch_dq(pb, torch.bfloat16), 6, 2 * q.numel()),
                "flash_bwd_dkv": (lambda: fb._launch_dkv(pb, torch.bfloat16), 8,
                                  2 * 2 * k.numel())}
        for kname, (fn, per_pair, written) in kern.items():
            flops = D * per_pair * pairs
            extra = 0 if kname == "flash_fwd" else 2 * w.numel() + 8 * lse.numel()
            nbytes = reads + extra + written + bias_bytes
            t = dict(**cuda_stats(fn), flops=flops, bytes=nbytes,
                     ops_ms=flops / H100_BF16_FLOPS * 1e3, bytes_ms=nbytes / H100_HBM_BYTES * 1e3,
                     dense_causal=dense[kname],
                     yardstick_ms=dense[kname]["ms"] * walked_pairs / causal_pairs)
            bound(t)
            res[kname] = t
        # Yardstick: the memory-efficient SDPA with the bool mask (K and V
        # expanded to the query heads), forward, and forward + backward.
        ids = (torch.arange(s, dtype=torch.int32)[None] // 512 if name == "causal_docs_512"
               else docs)
        if name == "window_512_0":
            i, j = torch.arange(s)[:, None], torch.arange(s)[None, :]
            bool_mask = ((j <= i) & (j >= i - 512))[None, None].to(dev)
        else:
            bool_mask = ((ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] >= 0)
                         & torch.ones((s, s), dtype=torch.bool).tril())[:, None].to(dev)
        ke, ve = (x.repeat_interleave(HQ // HKV, 1) for x in (k, v))
        qs_, ks_, vs_ = (x.detach().requires_grad_(True) for x in (q, ke, ve))
        res["sdpa"] = ("memory-efficient SDPA, the bool mask (B|1, 1, S, S), K and V expanded "
                       "to 16 heads; backward: dQ, dK and dV in one call")
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                res["sdpa_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, ke, ve, attn_mask=bool_mask))
                o = F.scaled_dot_product_attention(qs_, ks_, vs_, attn_mask=bool_mask)
            res["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(o, (qs_, ks_, vs_), w,
                                                                     retain_graph=True))
            del o
        except RuntimeError as e:  # a yardstick only: its refusal fails nothing
            res["sdpa_fwd_ms"] = res["sdpa_bwd_ms"] = None
            res["sdpa"] += f"; refused: {str(e)[:200]}"
        del ke, ve, qs_, ks_, vs_, bool_mask, p, pb, out, lse
        torch.cuda.empty_cache()
        emit({"phase": "block_sparse_path", **{kk: vv for kk, vv in res.items()
                                              if kk not in ("flash_fwd", "flash_bwd_dq",
                                                            "flash_bwd_dkv")},
              **{f"{kk}_ms": res[kk]["ms"] for kk in kern},
              **{f"{kk}_bound_ms": res[kk]["bound_ms"] for kk in kern},
              **{f"{kk}_dense_causal_ms": res[kk]["dense_causal"]["ms"] for kk in kern}})
        runs[name] = res
        if not res["ok"]:
            raise AssertionError(f"block-sparse {name}: the path disagrees with the plain "
                                 f"versions: {res}")
    del pb_dense, pf_dense
    torch.cuda.empty_cache()

    # (c) The reference's masks cell (bench.py:523-548): B2 H16 S4096 D64
    # bf16, 8 equal non-causal documents, forward, beside the dense
    # non-causal flash_fwd.
    bc = 2
    qc, kc, vc = (randn((bc, HQ, s, D), torch.bfloat16) for _ in range(3))
    cell = ut.segment_block_mask(torch.arange(s, dtype=torch.int32)[None] // 512, device=dev)
    pc = ff._prepare(qc, kc, vc, cell.bias, False, None, None, None, cell.walk())
    pcd = ff._prepare(qc, kc, vc, None, False, None, None, None)
    got = ff._launch(pc)
    want = ff.flash_attention_forward_plain(qc, kc, vc, cell.bias, block_map=cell.block_map,
                                            block_q=cell.block_q, block_k=cell.block_k)
    masks_cell = {"shape": f"B{bc} H{HQ} S{s} D{D} bf16, 8 documents of 512, non-causal",
                  "block_q": cell.block_q, "block_k": cell.block_k, "sparsity": cell.sparsity,
                  "relerr_out": rel_err(got[0], want[0]),
                  "sparse": cuda_stats(lambda: ff._launch(pc)),
                  "dense": cuda_stats(lambda: ff._launch(pcd))}
    masks_cell["speedup"] = masks_cell["dense"]["ms"] / masks_cell["sparse"]["ms"]
    emit({"phase": "block_sparse_masks_cell", **masks_cell})
    del qc, kc, vc, pc, pcd, got, want
    if masks_cell["relerr_out"] > 1e-2:
        raise AssertionError(f"the masks cell disagrees with the plain version: {masks_cell}")
    record["block_sparse"] = {"paths": runs, "masks_cell": masks_cell}
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        timing[kname] = {m: {kk: r[kname][kk] for kk in ("ms", "ms_min", "ms_max", "bound_ms",
                                                          "bound_by", "yardstick_ms")}
                         | {"dense_causal_ms": r[kname]["dense_causal"]["ms"],
                            "walked_share_of_causal": r["walked_share_of_causal"],
                            "sdpa_fwd_ms": r["sdpa_fwd_ms"], "sdpa_bwd_ms": r["sdpa_bwd_ms"]}
                         for m, r in runs.items()}
    timing["flash_fwd"]["masks_cell"] = {"ms": masks_cell["sparse"]["ms"],
                                         "dense_ms": masks_cell["dense"]["ms"]}
    del q, k, v, w
    torch.cuda.empty_cache()
    return timing, worst, counts_all


@contextlib.contextmanager
def plain_kernels():
    """The quantized path with every kernel wrapper's launch swapped for its
    plain version (same arguments and results, no launch counted): the
    whole path's plain version on the same inputs, for the comparisons."""
    from umfa_tpu_torch.ops import flash_bwd as fb
    from umfa_tpu_torch.ops import flash_fwd as ff
    from umfa_tpu_torch.ops import quant_attention as qa
    from umfa_tpu_torch.ops import quant_bwd as qb
    from umfa_tpu_torch.ops import quant_fused as qfu
    from umfa_tpu_torch.ops import quant_fused_attn as qf

    swaps = {
        (qf, "_launch"): qf._plain, (qa, "_launch"): qa._plain, (ff, "_launch"): ff._plain,
        (qb, "_launch"): lambda p, dt: tuple(g.to(dt) for g in (qb._plain_dq(p),
                                                                 *qb._plain_dkv(p))),
        (fb, "_launch"): lambda p, dt: tuple(g.to(dt) for g in fb._plain(p)),
        (qfu, "_launch"): lambda x, mean, precision, hadamard: qfu.quantize_rows_fused_plain(
            x, mean, precision=precision, hadamard=hadamard),
    }
    saved = {key: getattr(*key) for key in swaps}
    for (mod, name), fn in swaps.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def phase_quant_block_sparse(record):
    """Block-sparse masks on the quantized routes: (a) the walked
    instantiations of fused_qattn (row 7), quant_attn_fwd (row 5),
    quant_bwd_dq and quant_bwd_dkv (rows 8, 9) against their plain versions;
    (b) the full-width path, `attention(q, k, v, mask)` with `.backward()`
    under four quantization modes and two document masks, and one
    two-pass run, with exact launches, the plain path, timings beside the
    same recipe's unwalked causal kernels, the walked share and bounds."""
    import dataclasses as dc

    import torch

    import umfa_tpu_torch as ut
    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.engine.config import Precision, QuantMode, QuantStrategy
    from umfa_tpu_torch.ops import flash_bwd as fb
    from umfa_tpu_torch.ops import flash_fwd as ff
    from umfa_tpu_torch.ops import quant_attention as qa
    from umfa_tpu_torch.ops import quant_bwd as qb
    from umfa_tpu_torch.ops.block_mask import PARTIAL
    from umfa_tpu_torch.ops.quant import dequantize, quantize
    from umfa_tpu_torch.ops.quant_fused_attn import (
        fused_quantize_attend, fused_quantize_attend_plain,
    )
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(22)

    def randn(shape, dtype, offset=0.0):
        return (torch.randn(shape, generator=gen) + offset).to(dev, dtype)

    # (a) Walked kernels against their plain versions at B2 Hq16 Hkv8, bf16,
    # at the gates their unwalked instantiations meet in phase 8 (fused_qattn:
    # out relerr 1e-3, LSE 1e-4, codes at most one apart, means 1e-6; row 5:
    # 1e-3 / 1e-4; rows 8-9: 2e-2), rows that see no key included.
    # Each mask once, D 128 and 256 once each; the card tests take the rest.
    cases = [("causal", 1024, 1024, 64), ("segments_left_padded", 1024, 1024, 64),
             ("per_head", 1024, 1024, 64), ("blocks_96x160", 768, 1000, 128),
             ("aligned_no_bias", 1024, 1024, 64), ("segments_left_padded", 768, 1000, 256)]
    worst = {"fused_qattn": 0.0, "quant_attn_fwd": 0.0, "quant_bwd_dq": 0.0,
             "quant_bwd_dkv": 0.0}
    checks = []
    i8, i4 = Precision.INT8, Precision.INT4
    for kind, sq, sk, d in cases:
        mask = sparse_check_mask(kind, B_CHECK, sq, sk, dev)
        walk = dict(block_map=mask.block_map, block_q=mask.block_q, block_k=mask.block_k)
        tables = dict(fetch_kv=mask.fetch_kv, hold_kv=mask.hold_kv, fill_kv=mask.fill_kv)
        shape = {"mask": kind, "sq": sq, "sk": sk, "d": d, "block_q": mask.block_q,
                 "block_k": mask.block_k, "bias": mask.bias is not None,
                 "kv_mean_tiles": sorted(set(mask.kv_mean_tile.flatten().tolist()))}
        if kind == "segments_left_padded" and shape["kv_mean_tiles"] != [0, 1]:
            raise AssertionError(f"the left-padded mask's first fills {shape['kv_mean_tiles']}: "
                                 "batch 0's means window should be tile 1, batch 1's tile 0")
        q = randn((B_CHECK, HQ, sq, d), torch.bfloat16)
        k, v = randn((B_CHECK, HKV, sk, d), torch.bfloat16, 0.5), randn((B_CHECK, HKV, sk, d),
                                                                        torch.bfloat16, 0.3)
        for recipe in ("int8", "int4", "int8_block", "int8_asym", "qdense"):
            fkw = dict(recipe_kwargs(recipe), **walk, **tables)
            got = fused_quantize_attend(q, k, v, mask.bias, **fkw)
            torch.cuda.synchronize()
            want = fused_quantize_attend_plain(q, k, v, mask.bias, **fkw)
            vis = want[1] > -1e29
            blind = ~vis & (want[0].float() != 0).any(dim=-1)  # walked, no key seen
            res = {"case": f"fused_qattn/{recipe}/{kind}_{sq}x{sk}_d{d}", **shape,
                   "relerr_out": rel_err(got[0], want[0]),
                   "max_abs_lse": float((got[1][vis] - want[1][vis]).abs().max()),
                   "rows_no_key_walked": int(blind.sum()),
                   "relerr_rows_no_key": (rel_err(got[0][blind], want[0][blind])
                                          if blind.any() else 0.0),
                   "codes_close": all(codes_close(a, b_) for a, b_ in zip(got[2:5], want[2:5])
                                      if a is not None),
                   "relerr_means": max([rel_err(a, b_) for a, b_ in zip(got[5:], want[5:])
                                        if a is not None] + [0.0]),
                   "same_bits_twice": bool(torch.equal(
                       fused_quantize_attend(q, k, v, mask.bias, **fkw)[0], got[0]))}
            res["ok"] = (res["relerr_out"] <= 1e-3 and res["max_abs_lse"] <= 1e-4
                         and res["relerr_rows_no_key"] <= 1e-3 and res["codes_close"]
                         and res["relerr_means"] <= 1e-6 and res["same_bits_twice"]
                         and torch_isfinite(got[0].float()))
            for a, b_ in zip(got[2:5], want[2:5]):
                if a is not None and a.zero_points is not None:
                    res["ok"] = res["ok"] and int((a.zero_points - b_.zero_points).abs().max()) <= 1
            worst["fused_qattn"] = max(worst["fused_qattn"],
                                       float((got[0].float() - want[0].float()).abs().max()))
            emit({"phase": "kernel_check", **res})
            checks.append(res)
            if recipe in ("int8", "int4"):
                # Rows 8-9 on these residuals: smoothing on (int4: qm and the
                # corr row), a nonzero dlse.
                out, lse, qt_q, qt_k, qt_v, qm, vm = want
                do = randn(out.shape, out.dtype)
                dlse = torch.where(vis, randn(lse.shape, torch.float32), 0.0)
                corr = None if qm is None else qa._corr_from_quantized(qm, qt_k)
                args = (qt_q, qt_k, qt_v, out, lse, do, qm, vm, corr, mask.bias, dlse)
                gb = qb.quantized_attention_backward(*args, mask.block_map, mask.fetch_kv,
                                                     mask.fetch_q, grad_dtype=torch.bfloat16,
                                                     block_q=mask.block_q, block_k=mask.block_k)
                torch.cuda.synchronize()
                wb = qb.quantized_attention_backward_plain(*args, grad_dtype=torch.bfloat16,
                                                           **walk)
                bres = {"case": f"quant_bwd/{recipe}/{kind}_{sq}x{sk}_d{d}", **shape,
                        "tol": 2e-2, "no_key_rows_dq_zero": bool((gb[0][~vis] == 0).all())}
                for kern, g_name, x, y in zip(("quant_bwd_dq", "quant_bwd_dkv", "quant_bwd_dkv"),
                                              ("dq", "dk", "dv"), gb, wb):
                    bres[f"relerr_{g_name}"] = rel_err(x, y)
                    worst[kern] = max(worst[kern], float((x.float() - y.float()).abs().max()))
                bres["ok"] = bres["no_key_rows_dq_zero"] and all(
                    bres[f"relerr_{g_}"] <= 2e-2 for g_ in ("dq", "dk", "dv"))
                emit({"phase": "kernel_check", **bres})
                checks.append(bres)
                del gb, wb, args, do, dlse
            del got, want
        # Row 5: INT8, the int4 recipe's operands with its corr row, ASYMMETRIC.
        xs = (q.float(), k.float(), v.float())
        for name, precs, strategy, corr_on in (
                ("int8", (i8, i8, i8), QuantStrategy.SYMMETRIC, False),
                ("int4_corr", (i4, i4, i8), QuantStrategy.SYMMETRIC, True),
                ("asym", (i8, i8, i8), QuantStrategy.ASYMMETRIC, False)):
            qts = [quantize(x, pr, QuantMode.ROW, strategy) for x, pr in zip(xs, precs)]
            corr = randn((B_CHECK, HQ, 1, sk), torch.float32) if corr_on else None
            got = qa.quantized_attention_forward(*qts, mask.bias, corr, mask.block_map,
                                                 mask.fetch_kv, block_q=mask.block_q,
                                                 block_k=mask.block_k)
            torch.cuda.synchronize()
            want = qa.quantized_attention_forward_plain(*qts, mask.bias, corr, **walk)
            res = compare(f"quant_attn_fwd/{name}/{kind}_{sq}x{sk}_d{d}", got, want, 1e-3, 1e-4)
            res.update(shape)
            worst["quant_attn_fwd"] = max(worst["quant_attn_fwd"], res["max_abs_out"])
            emit({"phase": "kernel_check", **res})
            checks.append(res)
            del qts, got, want
        del q, k, v, mask
    torch.cuda.empty_cache()
    record["quant_block_sparse_checks"] = checks
    bad = [r["case"] for r in checks if not r["ok"]]
    if bad:
        raise AssertionError(f"walked quantized kernels disagree with their plain versions: {bad}")

    # (b) The full-width path: the GPT's attention geometry, bf16.
    b, s = B_TRAIN, S_TRAIN
    shape = f"B{b} Hq{HQ} Hkv{HKV} S{s} D{D} bf16"
    q, k, v = (randn((b, h, s, D), torch.bfloat16) for h in (HQ, HKV, HKV))
    w = randn((b, HQ, s, D), torch.bfloat16)
    docs = doc_ids(b, s, (64, 1536), 8, pad=200)
    masks = {"causal_docs_512": (ut.segment_block_mask(
                 torch.arange(s, dtype=torch.int32)[None] // 512, causal=True, device=dev),
                 b * (s // 512) * 512 * 513 // 2),
             "causal_docs_64_1536_padded": (ut.segment_block_mask(docs, causal=True, device=dev),
                                            causal_doc_pairs(docs))}
    causal_pairs = b * visible_pairs(s, s, -1, 0)
    runs_spec = [(recipe, name, False) for recipe in ("int8", "int4", "int8-block", "int8-asym")
                 for name in masks] + [("int8", "causal_docs_512", True)]
    fused_counts = {"fused_qattn": 1, "quant_bwd_dq": 1, "quant_bwd_dkv": 1, "quant_rows": 0,
                    "quant_attn_fwd": 0, "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                    "flash_dbias": 0}
    unwalked, runs, counts_all = {}, [], []
    for recipe, mname, bias_grad in runs_spec:
        mask, pairs1 = masks[mname]
        cfg = quant_config(recipe)
        asym = cfg.strategy == QuantStrategy.ASYMMETRIC
        want_counts = dict(fused_counts)
        if bias_grad:  # the two-pass route: quant_rows x 3, then row 5
            want_counts.update(fused_qattn=0, quant_rows=3, quant_attn_fwd=1)
        if asym:  # the fp32 dense backward on the dequantized operands
            want_counts.update(quant_bwd_dq=0, quant_bwd_dkv=0, flash_bwd_dq=1, flash_bwd_dkv=1)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        with ut.use_quantization(config=cfg):
            out, lse = ut.attention(qg, kg, vg, mask, return_lse=True, bias_grad=bias_grad)
        torch.autograd.backward((out, lse), (w, torch.where(lse > -1e29, 1.0, 0.0)))
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
        counts_all.append(counts)
        run = f"{recipe}{'/bias_grad' if bias_grad else ''}/{mname}"
        if {kk: counts.get(kk, 0) for kk in want_counts} != want_counts:
            raise AssertionError(f"quantized block-sparse {run}: launches {counts}, "
                                 f"expected {want_counts}")
        grads = (qg.grad, kg.grad, vg.grad)
        # The plain path on the same inputs (every wrapper's plain version).
        qp, kp, vp = (x.detach().requires_grad_(True) for x in (q, k, v))
        with plain_kernels(), ut.use_quantization(config=cfg):
            out_p, lse_p = ut.attention(qp, kp, vp, mask, return_lse=True, bias_grad=bias_grad)
            torch.autograd.backward((out_p, lse_p), (w, torch.where(lse_p > -1e29, 1.0, 0.0)))
        vis = lse_p > -1e29
        res = {"recipe": recipe, "mask": mname, "bias_grad": bias_grad, "shape": shape,
               "route": "two-pass" if bias_grad else "single-launch",
               "block_q": mask.block_q, "block_k": mask.block_k, "launches": counts,
               "relerr_out": rel_err(out.detach(), out_p.detach()),
               "max_abs_lse": float((lse[vis] - lse_p[vis]).detach().abs().max()),
               **{f"relerr_{g_}": rel_err(gx, px.grad)
                  for g_, gx, px in zip(("dq", "dk", "dv"), grads, (qp, kp, vp))}}
        res["ok"] = (res["relerr_out"] <= 1e-3 and res["max_abs_lse"] <= 1e-4
                     and torch_isfinite(out.float())
                     and all(res[f"relerr_{g_}"] <= 2e-2 for g_ in ("dq", "dk", "dv")))
        del qg, kg, vg, qp, kp, vp, out_p, lse_p, grads
        torch.cuda.empty_cache()
        # Walked share and the bytes of the bias the PARTIAL tiles read.
        walked = ff.walked_keys(ff.Walk(mask.block_map, None, None, mask.block_q, mask.block_k),
                                s, s)
        walked_pairs = int(walked.sum()) * (b if walked.shape[0] == 1 else 1)
        partial = (mask.block_map == PARTIAL).repeat_interleave(mask.block_q, 2)[:, :, :s] \
            .repeat_interleave(mask.block_k, 3)[..., :s]
        bias_bytes = 4 * int(partial.sum()) if mask.bias is not None else 0
        del walked, partial
        pairs = HQ * pairs1
        res.update(visible_pairs=pairs, walked_share_of_causal=walked_pairs / causal_pairs,
                   visible_share_of_causal=pairs1 / causal_pairs, bias_bytes_read=bias_bytes)
        # Each walked kernel timed on its own inputs, beside the same recipe's
        # unwalked causal kernel at the same shape.
        wk = mask.walk()
        rk = {"smooth": cfg.smooth, "smooth_q": cfg.effective_smooth_q(),
              "hadamard": cfg.hadamard, "q_precision": cfg.q_precision,
              "k_precision": cfg.k_precision, "v_precision": cfg.v_precision,
              "strategy": cfg.strategy, "mode": cfg.mode, "quant_blocks": cfg.block_sizes}
        mkw = dict(block_map=mask.block_map, fetch_kv=mask.fetch_kv, hold_kv=mask.hold_kv,
                   fill_kv=mask.fill_kv, block_q=mask.block_q, block_k=mask.block_k)
        # Bytes: each input read once and each output written once (codes one
        # byte an element; scales left out), the bias of PARTIAL tiles.
        codes = q.numel() + 2 * k.numel()
        rows = 4 * b * HQ * s  # an fp32 per query row (LSE, δ)
        kern = {}
        if bias_grad:  # the two-pass route's operands, residuals and row 5
            qt_q, qt_k, qt_v, qm, vm, corr2 = qa._quantize_operands(q, k, v, cfg)
            fwd = qa.quantized_attention_forward(qt_q, qt_k, qt_v, mask.bias, corr2,
                                                 mask.block_map, mask.fetch_kv,
                                                 block_q=mask.block_q, block_k=mask.block_k,
                                                 out_dtype=torch.bfloat16)
            kern["quant_attn_fwd"] = (
                lambda: qa.quantized_attention_forward(qt_q, qt_k, qt_v, mask.bias, corr2,
                                                       mask.block_map, mask.fetch_kv,
                                                       block_q=mask.block_q,
                                                       block_k=mask.block_k),
                lambda: qa.quantized_attention_forward(qt_q, qt_k, qt_v, None, corr2, causal=True),
                (2 * D * pairs / H100_INT8_OPS + 2 * D * pairs / H100_BF16_FLOPS) * 1e3,
                codes + 4 * q.numel() + rows + bias_bytes)
        else:
            _, _, qt_q, qt_k, qt_v, qm, vm = fwd = fused_quantize_attend(q, k, v, mask.bias, **rk,
                                                                         **mkw)
            kern["fused_qattn"] = (
                lambda: fused_quantize_attend(q, k, v, mask.bias, **rk, **mkw),
                lambda: fused_quantize_attend(q, k, v, causal=True, **rk),
                4 * D * pairs / H100_BF16_FLOPS * 1e3,
                2 * (q.numel() + 2 * k.numel()) + 2 * q.numel() + rows + codes + bias_bytes)
        f_out, f_lse = fwd[0], fwd[1]
        do = w
        dlse = torch.zeros_like(f_lse)
        if asym:
            qd, kd, vd = qa._dequantized(qt_q, qt_k, qt_v, qm, vm)
            pb = fb._prepare(qd, kd, vd, f_out.float(), f_lse, do.float(), mask.bias, dlse,
                             False, None, None, wk)
            pbc = fb._prepare(qd, kd, vd, f_out.float(), f_lse, do.float(), None, dlse,
                              True, None, None)
            names, launch, f32 = ("flash_bwd_dq", "flash_bwd_dkv"), fb, torch.float32
            rate, in_bytes, out_size = H100_TF32_FLOPS / 3, 4 * codes + 4 * do.numel(), 4
        else:
            corr = None if qm is None else qa._corr_from_quantized(qm, qt_k)
            pb = qb._prepare(qt_q, qt_k, qt_v, f_out, f_lse, do, qm, vm, corr, mask.bias,
                             dlse, False, None, None, wk)
            pbc = qb._prepare(qt_q, qt_k, qt_v, f_out, f_lse, do, qm, vm, corr, None,
                              dlse, True, None, None)
            names, launch, f32 = ("quant_bwd_dq", "quant_bwd_dkv"), qb, torch.bfloat16
            rate, in_bytes, out_size = H100_BF16_FLOPS, codes + 2 * do.numel(), 2
        # (3xTF32: three TF32 products for each fp32 one, at the TF32 rate.)
        bwd_bytes = in_bytes + 2 * rows + bias_bytes
        kern[names[0]] = (lambda: launch._launch_dq(pb, f32), lambda: launch._launch_dq(pbc, f32),
                          3 * 2 * D * pairs / rate * 1e3, bwd_bytes + out_size * q.numel())
        kern[names[1]] = (lambda: launch._launch_dkv(pb, f32),
                          lambda: launch._launch_dkv(pbc, f32),
                          4 * 2 * D * pairs / rate * 1e3, bwd_bytes + out_size * 2 * k.numel())
        for kname, (fn, fn_causal, ops_ms, nbytes) in kern.items():
            key = (recipe, bias_grad, kname)
            if key not in unwalked:
                unwalked[key] = cuda_stats(fn_causal)
            t = dict(**cuda_stats(fn), ops_ms=ops_ms, bytes=nbytes,
                     bytes_ms=nbytes / H100_HBM_BYTES * 1e3, unwalked_causal=unwalked[key])
            t["yardstick_ms"] = unwalked[key]["ms"] * walked_pairs / causal_pairs
            bound(t)
            res[kname] = t
        del fwd, f_out, f_lse, pb, pbc, kern, qt_q, qt_k, qt_v, qm, vm
        torch.cuda.empty_cache()
        emit({"phase": "quant_block_sparse_path",
              **{kk: vv for kk, vv in res.items() if not isinstance(vv, dict) or kk == "launches"},
              **{f"{kk}_ms": vv["ms"] for kk, vv in res.items()
                 if isinstance(vv, dict) and "ms" in vv},
              **{f"{kk}_bound_ms": vv["bound_ms"] for kk, vv in res.items()
                 if isinstance(vv, dict) and "bound_ms" in vv},
              **{f"{kk}_unwalked_causal_ms": vv["unwalked_causal"]["ms"] for kk, vv in res.items()
                 if isinstance(vv, dict) and "unwalked_causal" in vv}})
        runs.append(res)
        if not res["ok"]:
            raise AssertionError(f"quantized block-sparse {run}: the path disagrees with the "
                                 f"plain path: {res}")
    del q, k, v, w
    torch.cuda.empty_cache()
    record["quant_block_sparse"] = runs
    timing = collections.defaultdict(dict)
    for r in runs:
        for kname, t in r.items():
            if isinstance(t, dict) and "bound_ms" in t:
                label = f"{r['recipe']}{'/bias_grad' if r['bias_grad'] else ''}/{r['mask']}"
                timing[kname][label] = {kk: t[kk] for kk in ("ms", "ms_min", "ms_max", "bound_ms",
                                                           "bound_by", "yardstick_ms")} | {
                    "unwalked_causal_ms": t["unwalked_causal"]["ms"],
                    "walked_share_of_causal": r["walked_share_of_causal"]}
    return dict(timing), worst, counts_all


QRECIPES = ("int8", "int4", "int8_nosmooth", "qdense")


def recipe_kwargs(name):
    """fused_quantize_attend's switches for a recipe (the reference's
    QuantizationConfig.from_mode_string, and smoothing off); "_block" and
    "_asym" after a recipe's name add BLOCK scales (the default groups of
    128 Q and 64 K/V rows) and ASYMMETRIC quantization."""
    from umfa_tpu_torch.engine.config import Precision, QuantMode, QuantStrategy

    i8, i4, bf = Precision.INT8, Precision.INT4, Precision.BF16
    base, *extra = name.split("_")
    kw = {
        "int8": dict(q_precision=i8, k_precision=i8, v_precision=i8, smooth=True, smooth_q=False),
        "int4": dict(q_precision=i4, k_precision=i4, v_precision=i8, smooth=True, smooth_q=True,
                     hadamard=True),
        "qdense": dict(q_precision=bf, k_precision=i8, v_precision=i8, smooth=True),
    }[base]
    for e in extra:
        kw.update({"nosmooth": dict(smooth=False), "smoothq": dict(smooth_q=True),
                   "block": dict(mode=QuantMode.BLOCK),
                   "asym": dict(strategy=QuantStrategy.ASYMMETRIC)}[e])
    return kw


def quant_config(recipe):
    """The QuantizationConfig of a training recipe: a mode string of the
    reference ("int8", "int4", "int8-qdense"), "<precision>-block",
    "<precision>-asym" (that recipe, ASYMMETRIC), or "<recipe>-pv" (that
    recipe with pv_int8)."""
    import dataclasses as dc

    from umfa_tpu_torch.engine.config import QuantizationConfig, QuantStrategy

    if recipe.endswith("-pv"):
        return dc.replace(quant_config(recipe[:-3]), pv_int8=True)
    if recipe.endswith("-asym"):
        return dc.replace(QuantizationConfig.from_mode_string(recipe[:-5]),
                          strategy=QuantStrategy.ASYMMETRIC)
    if recipe.endswith("-block"):
        return QuantizationConfig.from_mode_string(recipe[:-6], "block")
    return QuantizationConfig.from_mode_string(recipe)


def codes_close(a, b):
    """Residual codes at most one apart and >= 99.9 % equal."""
    from umfa_tpu_torch.engine.config import Precision
    from umfa_tpu_torch.ops.quant import unpack_int4

    def codes(qt):
        return (unpack_int4(qt.values) if qt.precision == Precision.INT4 else qt.values).int()

    diff = (codes(a) - codes(b)).abs()
    return int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999


def phase_quant_kernels(record):
    """Rows 6-9 against their plain versions at B2 Hq16 Hkv8, then timed at
    the training shape beside their plain versions, bounds and (rows 8-9)
    the flash SDPA backward on the dequantized operands."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from umfa_tpu_torch.engine.config import Precision, QuantizationConfig
    from umfa_tpu_torch.ops import quant_attention as qa
    from umfa_tpu_torch.ops import quant_bwd as qb
    from umfa_tpu_torch.ops.quant import dequantize
    from umfa_tpu_torch.ops.quant_attention import _corr_from_quantized
    from umfa_tpu_torch.ops.quant_fused import (quantize_rows_fused, quantize_rows_fused_plain,
                                                rotate)
    from umfa_tpu_torch.ops.quant_fused_attn import (
        fused_quantize_attend, fused_quantize_attend_plain,
    )
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(9)

    def randn(shape, dtype=torch.float32, offset=0.0):
        return (torch.randn(shape, generator=gen) + offset).to(dev, dtype)

    worst = {"quant_rows": 0.0, "fused_qattn": 0.0, "quant_bwd_dq": 0.0, "quant_bwd_dkv": 0.0}
    results = []

    # Row 6: codes and scales exact without the rotation; with it codes at
    # most one apart (>= 99.9 % equal) and scales relerr <= 1e-6.
    for d in (32, 64, 128):
        for prec in (Precision.INT8, Precision.INT4):
            for had in (False, True):
                for dtype in (torch.float32, torch.bfloat16):
                    x = randn((B_CHECK, HQ, 1000, d), dtype, 0.3)
                    mean = x.float().mean(dim=2, keepdim=True)
                    got = quantize_rows_fused(x, mean, precision=prec, hadamard=had)
                    torch.cuda.synchronize()
                    want = quantize_rows_fused_plain(x, mean, precision=prec, hadamard=had)
                    exact = (torch.equal(got.values, want.values)
                             and torch.equal(got.scales, want.scales))
                    res = {"case": f"quant_rows/{prec.value}/{'hadamard' if had else 'plain'}/"
                                   f"{str(dtype)[6:]}/d{d}",
                           "exact": exact, "codes_close": codes_close(got, want),
                           "relerr_scales": rel_err(got.scales, want.scales)}
                    res["ok"] = exact if not had else (res["codes_close"]
                                                       and res["relerr_scales"] <= 1e-6)
                    worst["quant_rows"] = max(worst["quant_rows"],
                                              float((got.scales - want.scales).abs().max()))
                    results.append(res)
                    emit({"phase": "kernel_check", **res})

    # Rows 7-9 at the check shapes.
    cases = [  # name, sq, sk, d, recipe, kwargs
        ("int8_causal_1024", 1024, 1024, 64, "int8", dict(causal=True)),
        ("int4_causal_1024", 1024, 1024, 64, "int4", dict(causal=True)),
        ("int8_777_noncausal", 777, 777, 64, "int8", {}),
        ("int8_window_128_0", 1024, 1024, 64, "int8", dict(window=(128, 0))),
        ("int8_nosmooth_bias_11qk", 512, 512, 64, "int8_nosmooth", dict(bias=True)),
        ("int4_left_window_1024x256", 1024, 256, 64, "int4", dict(window=(64, -1))),
        ("int8_d32_causal", 1024, 1024, 32, "int8", dict(causal=True)),
        ("int4_d128_causal", 1024, 1024, 128, "int4", dict(causal=True)),
        ("qdense_causal_1024", 1024, 1024, 64, "qdense", dict(causal=True)),
        ("int8_d256_causal", 1024, 1024, 256, "int8", dict(causal=True)),
        ("int4_d256_window_128_0", 777, 777, 256, "int4", dict(window=(128, 0))),
        # BLOCK and ASYMMETRIC: every operand through the pre-pass, Q read
        # as bf16 by the attention; odd lengths leave the last groups short.
        ("int8_block_causal_1024", 1024, 1024, 64, "int8_block", dict(causal=True)),
        ("int4_block_window_777_d128", 777, 777, 128, "int4_block", dict(window=(128, 0))),
        ("int8_asym_causal_1024", 1024, 1024, 64, "int8_asym", dict(causal=True)),
        ("int4_asym_causal_777_d256", 777, 777, 256, "int4_asym", dict(causal=True)),
        ("int8_asym_block_bias_512", 512, 512, 64, "int8_smoothq_asym_block", dict(bias=True)),
        ("qdense_asym_causal_1024", 1024, 1024, 64, "qdense_asym", dict(causal=True)),
    ]
    bwd_tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    for name, sq, sk, d, recipe, kw in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn((B_CHECK, HQ, sq, d), dtype)
            k, v = randn((B_CHECK, HKV, sk, d), dtype, 0.5), randn((B_CHECK, HKV, sk, d), dtype, 0.3)
            fkw = dict(recipe_kwargs(recipe), causal=kw.get("causal", False), window=kw.get("window"))
            if kw.get("bias"):
                fkw["bias"] = randn((1, 1, sq, sk))
            got = fused_quantize_attend(q, k, v, **fkw)
            torch.cuda.synchronize()
            want = fused_quantize_attend_plain(q, k, v, **fkw)
            lse, w_lse = got[1], want[1]
            vis = w_lse > -1e29
            res = {"case": f"fused_qattn/{recipe}/{str(dtype)[6:]}/{name}",
                   "relerr_out": rel_err(got[0], want[0]),
                   "max_abs_out": float((got[0].float() - want[0].float()).abs().max()),
                   "max_abs_lse": float((lse[vis] - w_lse[vis]).abs().max()) if vis.any() else 0.0,
                   "empty_rows": int((~vis).sum()),
                   "empty_rows_exact": bool((got[0][~vis] == 0).all()
                                            and (lse[~vis] == -1e30).all()),
                   "codes_close": all(codes_close(a, b) for a, b in zip(got[2:5], want[2:5])
                                      if a is not None),
                   "relerr_means": max([rel_err(a, b) for a, b in zip(got[5:], want[5:])
                                        if a is not None] + [0.0]),
                   "finite": torch_isfinite(got[0].float()) and torch_isfinite(lse)}
            res["ok"] = (res["relerr_out"] <= 1e-3 and res["max_abs_lse"] <= 1e-4
                         and res["empty_rows_exact"] and res["codes_close"]
                         and res["relerr_means"] <= 1e-6 and res["finite"])
            for a, b_ in zip(got[2:5], want[2:5]):
                if a is not None and a.zero_points is not None:
                    diff = (a.zero_points - b_.zero_points).abs()
                    res["ok"] = res["ok"] and int(diff.max()) <= 1
            worst["fused_qattn"] = max(worst["fused_qattn"], res["max_abs_out"])
            results.append(res)
            emit({"phase": "kernel_check", **res})
            if recipe.startswith("qdense") or "asym" in recipe:
                continue  # the dense backward's (rows 2-3), checked in phase 4
            # The STE backward on the kernel's residuals, with 64 rows of
            # LSE -1e30 (no visible key) and a nonzero dlse.
            out, lse, qt_q, qt_k, qt_v, qm, vm = got
            lse = lse.clone()
            lse[:, :, :64] = -1e30
            do, dlse = randn(out.shape, out.dtype), randn(lse.shape)
            corr = None if qm is None else _corr_from_quantized(qm, qt_k)
            args = (qt_q, qt_k, qt_v, out, lse, do, qm, vm, corr, fkw.get("bias"), dlse)
            mask = dict(causal=fkw["causal"], window=fkw["window"])
            gdt = torch.bfloat16 if dtype == torch.bfloat16 else None
            gb = qb.quantized_attention_backward(*args, grad_dtype=gdt, **mask)
            torch.cuda.synchronize()
            wb = qb.quantized_attention_backward_plain(*args, grad_dtype=gdt, **mask)
            res = {"case": f"quant_bwd/{recipe}/{str(dtype)[6:]}/{name}", "tol": bwd_tol[dtype],
                   "masked_rows_exact": bool((gb[0][:, :, :64] == 0).all())}
            for kernel, grad, g_, w in zip(("quant_bwd_dq", "quant_bwd_dkv", "quant_bwd_dkv"),
                                           ("dq", "dk", "dv"), gb, wb):
                res[f"relerr_{grad}"] = rel_err(g_, w)
                res[f"finite_{grad}"] = torch_isfinite(g_.float())
                worst[kernel] = max(worst[kernel], float((g_.float() - w.float()).abs().max()))
            res["ok"] = res["masked_rows_exact"] and all(
                res[f"relerr_{g_}"] <= bwd_tol[dtype] and res[f"finite_{g_}"]
                for g_ in ("dq", "dk", "dv"))
            results.append(res)
            emit({"phase": "kernel_check", **res})
            del got, want, gb, wb, args
    # The score bits: causal S 1024 with q ~ N(0, 3) (short causal rows,
    # where fp32 score sums in another order flip bf16(P)), the LSE held to
    # 1e-5, at D 64 and 256 (256 products a score, still exact in double),
    # also under BLOCK and ASYMMETRIC (code − zp spans up to 256 steps).
    for d, recipe in ((64, "int8"), (256, "int8"), (64, "int8_block"), (64, "int8_asym"),
                      (256, "int4_asym")):
        q = (3 * torch.randn((B_CHECK, HQ, 1024, d), generator=gen)).to(dev, torch.bfloat16)
        k, v = randn((B_CHECK, HKV, 1024, d), torch.bfloat16), randn((B_CHECK, HKV, 1024, d),
                                                                     torch.bfloat16)
        fkw = dict(recipe_kwargs(recipe), causal=True)
        got = fused_quantize_attend(q, k, v, **fkw)
        torch.cuda.synchronize()
        want = fused_quantize_attend_plain(q, k, v, **fkw)
        res = {"case": f"fused_qattn/{recipe}/bfloat16/score_bits_d{d}", "tol_lse": 1e-5,
               "max_abs_lse": float((got[1] - want[1]).abs().max()),
               "relerr_out": rel_err(got[0], want[0])}
        res["ok"] = res["max_abs_lse"] <= 1e-5 and res["relerr_out"] <= 1e-3
        results.append(res)
        emit({"phase": "kernel_check", **res})
        del q, k, v, got, want
    # Row 5's INT4 operands (unpacked while staged), the Q-mean corr row and
    # ASYMMETRIC zero points, against the plain version at the INT8 gates
    # (out relerr 1e-3, LSE 1e-4), D 64, 128, 256 and 66 (INT4 unpacked and
    # zero-padded to 80 by the wrapper).
    from umfa_tpu_torch.engine.config import QuantMode, QuantStrategy
    from umfa_tpu_torch.ops.quant import quantize

    worst["quant_attn_fwd"] = 0.0
    i4, i8 = Precision.INT4, Precision.INT8
    for d in (64, 128, 256, 66):
        for name, precs, strategy, corr_on in (
                ("int4_qk_corr", (i4, i4, i8), QuantStrategy.SYMMETRIC, True),
                ("int8_asym", (i8, i8, i8), QuantStrategy.ASYMMETRIC, False),
                ("int4_asym_corr", (i4, i4, i8), QuantStrategy.ASYMMETRIC, True)):
            xs = (randn((B_CHECK, HQ, 1024, d)), randn((B_CHECK, HKV, 1024, d), offset=0.4),
                  randn((B_CHECK, HKV, 1024, d), offset=0.2))
            qts = [quantize(x, pr, QuantMode.ROW, strategy) for x, pr in zip(xs, precs)]
            corr = randn((B_CHECK, HQ, 1, 1024)) if corr_on else None
            got = qa.quantized_attention_forward(*qts, None, corr, causal=True)
            torch.cuda.synchronize()
            want = qa.quantized_attention_forward_plain(*qts, None, corr, causal=True)
            res = compare(f"quant_attn_fwd/{name}/d{d}", got, want, 1e-3, 1e-4)
            worst["quant_attn_fwd"] = max(worst["quant_attn_fwd"], res["max_abs_out"])
            results.append(res)
            emit({"phase": "kernel_check", **res})
            del xs, qts, got, want
    record["quant_kernel_checks"] = results
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"quantized kernels disagree with their plain versions: {bad}")
    torch.cuda.empty_cache()

    # Timing at the training shape: B8 Hq16 Hkv8 S4096 D64 causal bf16.
    b, s = B_TRAIN, S_TRAIN
    shape = f"B{b} Hq{HQ} Hkv{HKV} Sq{s} Sk{s} D{D} causal bf16"
    pairs = b * HQ * visible_pairs(s, s, -1, 0)
    q, k, v = (randn((b, HQ, s, D), torch.bfloat16), randn((b, HKV, s, D), torch.bfloat16, 0.5),
               randn((b, HKV, s, D), torch.bfloat16, 0.3))
    timing = {}

    def fused_timing(recipe, q, k, v):
        d = q.shape[3]
        kw = dict(recipe_kwargs(recipe), causal=True)
        fk = lambda: fused_quantize_attend(q, k, v, **kw)  # noqa: E731
        fp = lambda: fused_quantize_attend_plain(q, k, v, **kw)  # noqa: E731
        got, want = fk(), fp()
        check = {"out": rel_err(got[0], want[0]),
                 "max_abs_lse": float((got[1] - want[1]).abs().max()),
                 "codes_close": all(codes_close(a, b_) for a, b_ in zip(got[2:5], want[2:5]))}
        worst["fused_qattn"] = max(worst["fused_qattn"],
                                   float((got[0].float() - want[0].float()).abs().max()))
        res_bytes = sum(t.values.numel() + 4 * t.scales.numel()
                        + (0 if t.zero_points is None else 4 * t.zero_points.numel())
                        for t in got[2:5])
        res_bytes += sum(4 * t.numel() for t in got[5:] if t is not None)
        del got, want
        torch.cuda.empty_cache()
        # QKᵀ and P·V over the visible pairs; with the rotation, x·H on each
        # Q and K row (2·D² each); the per-element quantize work is O(S·D).
        flops = 4 * d * pairs
        if kw.get("hadamard"):
            flops += 2 * d * d * (q.numel() + k.numel()) // d
        in_bytes = 2 * (q.numel() + k.numel() + v.numel())
        nbytes = in_bytes + q.numel() * 2 + 4 * b * HQ * s + res_bytes  # + out, lse, residuals
        t = dict(**cuda_stats(fk), plain_ms=cuda_ms(fp, iters=3, warmup=1), flops=flops,
                 bytes=nbytes, ops_ms=flops / H100_BF16_FLOPS * 1e3,
                 bytes_ms=nbytes / H100_HBM_BYTES * 1e3, check=check,
                 ok=(check["out"] <= 1e-3 and check["max_abs_lse"] <= 1e-5
                     and check["codes_close"]),
                 library_ms=None,
                 library="none: no single PyTorch call quantizes and attends")
        # The floor of the exact score contract: both passes' QKᵀ in double
        # on the FP64 tensor cores, over the visible pairs.
        t["fp64_flops"] = 2 * 2 * d * pairs
        t["fp64_floor_ms"] = t["fp64_flops"] / H100_FP64_TC_FLOPS * 1e3
        t["share_of_fp64_floor"] = t["fp64_floor_ms"] / t["ms"]
        return t

    timing["fused_qattn"] = fused_timing("int8", q, k, v)
    timing["fused_qattn_int4"] = fused_timing("int4", q, k, v)
    for recipe in ("int8_block", "int4_block", "int8_asym", "int4_asym"):
        timing[f"fused_qattn_{recipe}"] = fused_timing(recipe, q, k, v)
    # quant_attn_fwd on the two-pass route's operands at the training shape,
    # each from the two-pass quantizer: INT8 (symmetric ROW, the same
    # kernel's common form, for comparison in this call), the int4 recipe's
    # (Q and K INT4 with the rotation, V INT8, the Q-mean corr row) and
    # ASYMMETRIC INT8 (zero points and row sums, V's scale on P).
    for name, recipe in (("quant_attn_fwd_int8", "int8"), ("quant_attn_fwd_int4_corr", "int4"),
                         ("quant_attn_fwd_asym", "int8-asym")):
        qt_q, qt_k, qt_v, _, _, corr = qa._quantize_operands(q, k, v, quant_config(recipe))
        qts = (qt_q, qt_k, qt_v)
        qk = lambda qts=qts, corr=corr: qa.quantized_attention_forward(  # noqa: E731
            *qts, None, corr, causal=True)
        qp = lambda qts=qts, corr=corr: qa.quantized_attention_forward_plain(  # noqa: E731
            *qts, None, corr, causal=True)
        res = compare(name, qk(), qp(), 1e-3, 1e-4)
        int_ops = bf16_flops = 2 * D * pairs
        nbytes = (sum(t.values.numel() + 4 * t.scales.numel() for t in qts)
                  + sum(4 * t.zero_points.numel() + 4 * t.row_sums.numel()
                        for t in qts if t.zero_points is not None and t.row_sums is not None)
                  + (0 if corr is None else 4 * corr.numel()) + 4 * q.numel() + 4 * b * HQ * s)
        timing[name] = dict(
            **cuda_stats(qk), plain_ms=cuda_ms(qp, iters=3, warmup=1),
            flops=int_ops + bf16_flops, int8_ops=int_ops, bf16_flops=bf16_flops, bytes=nbytes,
            ops_ms=(int_ops / H100_INT8_OPS + bf16_flops / H100_BF16_FLOPS) * 1e3,
            bytes_ms=nbytes / H100_HBM_BYTES * 1e3, check=res, ok=res["ok"], library_ms=None,
            library="none: no single PyTorch call computes int8 attention")
        del qts, qt_q, qt_k, qt_v, corr
        torch.cuda.empty_cache()
    # At D 256, beside the FP64 floor, the two-pass route's forward on the
    # same inputs (quant_rows three times, then quant_attn_fwd; true means,
    # not tile-0 estimates: other numbers, a yardstick).
    q2, k2, v2 = (randn((b, HQ, s, 256), torch.bfloat16), randn((b, HKV, s, 256), torch.bfloat16, 0.5),
                  randn((b, HKV, s, 256), torch.bfloat16, 0.3))
    t = fused_timing("int8", q2, k2, v2)
    cfg = QuantizationConfig.from_mode_string("int8")
    t["two_pass_ms"] = cuda_ms(lambda: qa._two_pass(q2, k2, v2, None, cfg, True, None, None, None))
    t["two_pass"] = "quant_rows x 3, quant_attn_fwd and the V-mean restore, int8, same inputs"
    timing["fused_qattn_d256"] = t
    del q2, k2, v2
    torch.cuda.empty_cache()

    # quant_rows on Q (bytes-bound: bf16 in, int8 codes and fp32 scales out).
    # Before each timing the 50 MB L2 is evicted by reading 256 MB and the
    # card spins while the host enqueues the call, so the events time the
    # device, not the Python wrapper (`ms_host`: the same call without).
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    def evict():
        flush_buf.sum()
        torch.cuda._sleep(1_000_000)

    mean = q.float().mean(dim=2, keepdim=True)
    rk = lambda: quantize_rows_fused(q, mean)  # noqa: E731
    rp = lambda: quantize_rows_fused_plain(q, mean)  # noqa: E731
    got, want = rk(), rp()
    exact = torch.equal(got.values, want.values) and torch.equal(got.scales, want.scales)
    nbytes = 2 * q.numel() + q.numel() + 4 * b * HQ * s + 4 * mean.numel()
    flops = 4 * q.numel()  # subtract, |x|, divide, round per element
    timing["quant_rows"] = dict(ms=cuda_ms(rk, before=evict), ms_host=cuda_ms(rk),
                                plain_ms=cuda_ms(rp, iters=3, warmup=1, before=evict),
                                flops=flops, bytes=nbytes, ops_ms=flops / H100_BF16_FLOPS * 1e3,
                                bytes_ms=nbytes / H100_HBM_BYTES * 1e3, check={"exact": exact},
                                ok=exact, library_ms=None,
                                library="none: no single PyTorch call row-quantizes to int8")
    del got, want
    # The rotated path (int8, the mean in the rotated space) at D 64 and 128.
    for d in (64, 128):
        x = q if d == D else randn((b, HQ, s, d), torch.bfloat16)
        xm = rotate(x.float()).mean(dim=2, keepdim=True)
        got = quantize_rows_fused(x, xm, hadamard=True)
        want = quantize_rows_fused_plain(x, xm, hadamard=True)
        timing["quant_rows"][f"rotated_d{d}"] = {
            "ms": cuda_ms(lambda: quantize_rows_fused(x, xm, hadamard=True), before=evict),
            "bytes_ms": (3 * x.numel() + 4 * x.numel() // d + 4 * xm.numel())
            / H100_HBM_BYTES * 1e3,
            "codes_off_by_one_at_most": int((got.values.int() - want.values.int()).abs().max()) <= 1,
            "scales_relerr": rel_err(got.scales, want.scales)}
        del x, xm, got, want
    del mean, flush_buf

    # The backward kernels on the int8 recipe's residuals.
    out, lse, qt_q, qt_k, qt_v, qm, vm = fused_quantize_attend(q, k, v, causal=True,
                                                               **recipe_kwargs("int8"))
    do = randn(out.shape, torch.bfloat16)
    p = qb._prepare(qt_q, qt_k, qt_v, out, lse, do, qm, vm, None, None, None, True, None, None)
    reads = (sum(t.values.numel() + 4 * t.scales.numel() for t in (qt_q, qt_k, qt_v))
             + 2 * do.numel() + 4 * 2 * lse.numel() + 4 * vm.numel())
    passes = {
        "quant_bwd_dq": (lambda: (qb._launch_dq(p, torch.bfloat16),),
                         lambda: (qb._plain_dq(p),), 3, 2 * q.numel(), ("dq",)),
        "quant_bwd_dkv": (lambda: qb._launch_dkv(p, torch.bfloat16),
                          lambda: qb._plain_dkv(p), 4, 2 * 2 * k.numel(), ("dk", "dv")),
    }
    for name, (kern, plain, products, written, grads) in passes.items():
        got, want = kern(), plain()
        check = {g_: rel_err(x, y) for g_, x, y in zip(grads, got, want)}
        worst[name] = max(worst[name], *(float((x.float() - y.float()).abs().max())
                                         for x, y in zip(got, want)))
        del got, want
        flops = 2 * D * products * pairs
        nbytes = reads + written
        timing[name] = dict(**cuda_stats(kern), plain_ms=cuda_ms(plain, iters=3, warmup=1),
                            flops=flops, bytes=nbytes, ops_ms=flops / H100_BF16_FLOPS * 1e3,
                            bytes_ms=nbytes / H100_HBM_BYTES * 1e3, check=check,
                            ok=all(e <= 2e-2 for e in check.values()))
        torch.cuda.empty_cache()
    # Yardstick: the flash SDPA backward on the dequantized operands (the
    # same function to bf16 grade), dQ, dK and dV in one call.
    qd = dequantize(qt_q, torch.bfloat16).requires_grad_(True)
    kd = dequantize(qt_k, torch.bfloat16).requires_grad_(True)
    vd = (dequantize(qt_v, torch.float32) + vm).to(torch.bfloat16).requires_grad_(True)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o = F.scaled_dot_product_attention(qd, kd, vd, is_causal=True, enable_gqa=True)
    sdpa_ms = cuda_ms(lambda: torch.autograd.grad(o, (qd, kd, vd), do, retain_graph=True))
    for name in passes:
        timing[name].update(library_ms=sdpa_ms,
                            library="flash SDPA backward on the dequantized operands "
                                    "(dQ, dK and dV in one call), enable_gqa")
    del qd, kd, vd, o, p, q, k, v, out, lse, qt_q, qt_k, qt_v, qm, vm, do
    torch.cuda.empty_cache()

    for name, t in timing.items():
        if not t["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version at the training shape: "
                                 f"{t['check']}")
        bound(t)
        emit({"phase": "kernel_timing", "kernel": name,
              "shape": {"fused_qattn_int4": shape + " int4 recipe",
                        "fused_qattn_d256": shape.replace(f"D{D}", "D256")}.get(name, shape), **t})
    record["quant_kernel_timing"] = timing
    t256 = timing["fused_qattn_d256"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    timing["fused_qattn"]["variants"] = [
        {"shape": shape.replace(f"D{D}", "D256") + ", int8 recipe",
         **{k2: t256[k2] for k2 in keys + ("fp64_floor_ms", "two_pass_ms")}}] + [
        {"shape": f"{shape}, {recipe} recipe",
         **{k2: timing[f"fused_qattn_{recipe}"][k2] for k2 in keys + ("fp64_floor_ms",)}}
        for recipe in ("int4", "int8_block", "int4_block", "int8_asym", "int4_asym")]
    # Row 5's variants, beside its prefill line (phase 3) in the kernels line.
    timing["quant_attn_fwd_variants"] = [
        {"shape": f"{shape}, {name[15:]}", **{k2: timing[name][k2] for k2 in keys}}
        for name in ("quant_attn_fwd_int8", "quant_attn_fwd_int4_corr", "quant_attn_fwd_asym")]
    return timing, worst


def pv_pairs(b, s, causal, docs=None):
    """Visible (query, key) pairs of b x HQ heads at Sq = Sk = s: all,
    causal, or causal inside documents of `docs` keys."""
    if docs:
        return b * HQ * (s // docs) * docs * (docs + 1) // 2
    return b * HQ * (visible_pairs(s, s, -1, 0) if causal else s * s)


def phase_pv_int8(record):
    """pv_int8, the integer P·V of rows 7 (chunked local max) and 5: each PV
    instantiation against its plain version (out relerr 1e-3, LSE 1e-3, the
    V residual's codes at most one apart, and the count of P codes that
    differ from the plain version's), timed (median, min and max of 10)
    beside the same call without pv_int8, its plain version and its bound
    (QKᵀ at the bf16 rate, or int8 on row 5, P·V at the int8 rate; row 7
    also its FP64 floor); then the accuracy cell of bench.py:852-884 (B2 H16
    S4096 D64, iid bf16, non-causal): int8 and int8 pv_int8 against fp64
    attention, pv_int8 held to 0.02."""
    import dataclasses as dc

    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.engine.config import Precision, QuantizationConfig
    from umfa_tpu_torch.ops import block_mask as tbm
    from umfa_tpu_torch.ops import quant_attention as qa
    from umfa_tpu_torch.ops.flash_fwd import BlockSizes, _choose_block
    from umfa_tpu_torch.ops.quant_fused_attn import _fused, _map_walk
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(24)

    def randn(shape, offset=0.0):
        return (torch.randn(shape, generator=gen) + offset).to(dev, torch.bfloat16)

    worst = {"fused_qattn": 0.0, "quant_attn_fwd": 0.0}
    lines = {"fused_qattn": [], "quant_attn_fwd": []}
    results, path_counts = [], []

    # Row 7: the training shape first, then the variants at B2.
    cases = [  # name, b, s, d, recipe, causal, documents of n keys
        ("int8_row_causal", B_TRAIN, S_TRAIN, D, "int8", True, None),
        ("int8_block_causal", B_CHECK, S_TRAIN, D, "int8_block", True, None),
        ("qdense_causal", B_CHECK, S_TRAIN, D, "qdense", True, None),
        ("int8_d128_causal", B_CHECK, S_TRAIN, 128, "int8", True, None),
        ("int8_d256_causal", B_CHECK, S_TRAIN, 256, "int8", True, None),
        ("int8_noncausal", B_CHECK, S_TRAIN, D, "int8", False, None),
        ("int8_docs512_block_mask", B_CHECK, S_TRAIN, D, "int8", True, 512),
    ]
    for name, b, s, d, recipe, causal, docs in cases:
        q, k, v = randn((b, HQ, s, d)), randn((b, HKV, s, d), 0.5), randn((b, HKV, s, d), 0.3)
        kw = dict(recipe_kwargs(recipe), causal=causal)
        walk = None
        bias = None
        if docs:
            # Aligned documents: the map's tiles are FULL or SKIP (no bias),
            # causal by the index mask.
            ids = (torch.arange(s, dtype=torch.int32) // docs)[None].expand(b, s).contiguous()
            bm = tbm.segment_block_mask(ids.to(dev), block_sizes=BlockSizes(128, 128))
            walk = _map_walk(bm.block_map, bm.fetch_kv, bm.hold_kv, bm.fill_kv, bm.block_q,
                             bm.block_k)
            bias = bm.bias
        shape = (f"B{b} Hq{HQ} Hkv{HKV} S{s} D{d} {'causal' if causal else 'non-causal'} bf16 "
                 f"{recipe}" + (f", documents of {docs} (BlockMask 128 x 128)" if docs else ""))
        codes = [torch.zeros((b, HQ, s, s), dtype=torch.uint8, device=dev) for _ in "kp"]
        got = _fused(q, k, v, bias, walk, pv_int8=True, p_codes=codes[0], **kw)
        torch.cuda.synchronize()
        want = _fused(q, k, v, bias, walk, plain=True, pv_int8=True, p_codes=codes[1], **kw)
        differ = codes[0] != codes[1]
        n_differ, n_codes = int(differ.sum()), int((codes[1] > 0).sum())
        code_gap = int((codes[0].int() - codes[1].int()).abs().max())
        del codes, differ
        lse, w_lse = got[1], want[1]
        vis = w_lse > -1e29
        res = {"case": f"fused_qattn/pv/{name}", "shape": shape,
               "relerr_out": rel_err(got[0], want[0]),
               "max_abs_out": float((got[0].float() - want[0].float()).abs().max()),
               "max_abs_lse": float((lse[vis] - w_lse[vis]).abs().max()),
               "codes_close": all(codes_close(a, b_) for a, b_ in zip(got[2:5], want[2:5])
                                  if a is not None),
               "v_group": got[4].block_size, "p_codes_differ": n_differ,
               "p_codes_nonzero": n_codes, "p_code_gap": code_gap,
               "finite": torch_isfinite(got[0].float()) and torch_isfinite(lse),
               "tol_out": 1e-3, "tol_lse": 1e-3}
        res["ok"] = (res["relerr_out"] <= 1e-3 and res["max_abs_lse"] <= 1e-3
                     and res["codes_close"] and res["finite"])
        worst["fused_qattn"] = max(worst["fused_qattn"], res["max_abs_out"])
        res_bytes = sum(t.values.numel() + 4 * t.scales.numel() for t in got[2:5]
                        if t is not None)
        res_bytes += sum(4 * t.numel() for t in got[5:] if t is not None)
        del got, want
        torch.cuda.empty_cache()
        fk = lambda: _fused(q, k, v, bias, walk, pv_int8=True, **kw)  # noqa: E731
        fb = lambda: _fused(q, k, v, bias, walk, **kw)  # noqa: E731
        fp = lambda: _fused(q, k, v, bias, walk, plain=True, pv_int8=True, **kw)  # noqa: E731
        pairs = pv_pairs(b, s, causal, docs)
        flops = 4 * d * pairs
        nbytes = 2 * (q.numel() + k.numel() + v.numel()) + 2 * q.numel() + 4 * b * HQ * s
        nbytes += res_bytes
        t = dict(**cuda_stats(fk), non_pv_ms=cuda_ms(fb), plain_ms=cuda_ms(fp, iters=3, warmup=1),
                 flops=flops, bytes=nbytes,
                 ops_ms=(2 * d * pairs / H100_BF16_FLOPS + 2 * d * pairs / H100_INT8_OPS) * 1e3,
                 bytes_ms=nbytes / H100_HBM_BYTES * 1e3,
                 fp64_floor_ms=2 * 2 * d * pairs / H100_FP64_TC_FLOPS * 1e3,
                 library_ms=None, library="none: no single PyTorch call quantizes and attends")
        bound(t)
        res["timing"] = t
        emit({"phase": "pv_int8_check", **res})
        results.append(res)
        lines["fused_qattn"].append(
            {"shape": shape + ", pv_int8", **{key: t[key] for key in (
                "ms", "ms_min", "ms_max", "non_pv_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "fp64_floor_ms")},
             "relerr_out": res["relerr_out"], "max_abs_lse": res["max_abs_lse"],
             "p_codes_differ": n_differ, "p_codes_nonzero": n_codes})
        del q, k, v, bias, walk
        torch.cuda.empty_cache()

    # Row 5 on the two-pass route's operands (V BLOCK-quantized per the
    # reference's KV tile, 2048 keys here): the prefill shape under int8,
    # and the int4 recipe (INT4 Q and K, the Q-mean corr row) at B2.
    for name, b, sq, recipe in (("int8_prefill", B_SERVE, PROMPT, "int8"),
                                ("int4_corr", B_CHECK, SK, "int4")):
        q, k, v = randn((b, HQ, sq, D)), randn((b, HKV, SK, D), 0.5), randn((b, HKV, SK, D), 0.3)
        cfg = dc.replace(quant_config(recipe), pv_int8=True)
        tile = _choose_block(BlockSizes().block_k, SK, D)
        qt_q, qt_k, qt_v, _, _, corr = qa._quantize_operands(q, k, v, cfg, tile)
        qts = (qt_q, qt_k, qt_v)
        qk = lambda pv=True: qa.quantized_attention_forward(  # noqa: E731
            *qts, None, corr, causal=True, pv_int8=pv)
        qp = lambda: qa.quantized_attention_forward_plain(  # noqa: E731
            *qts, None, corr, causal=True, pv_int8=True)
        shape = f"B{b} Hq{HQ} Hkv{HKV} Sq{sq} Sk{SK} D{D} causal bf16 {recipe}, V per {tile} keys"
        res = compare(f"quant_attn_fwd/pv/{name}", qk(), qp(), 1e-3, 1e-3)
        res["shape"] = shape
        worst["quant_attn_fwd"] = max(worst["quant_attn_fwd"], res["max_abs_out"])
        pairs = b * HQ * visible_pairs(sq, SK, -1, 0)
        nbytes = (sum(t_.values.numel() + 4 * t_.scales.numel() for t_ in qts)
                  + (0 if corr is None else 4 * corr.numel()) + 4 * q.numel() + 4 * b * HQ * sq)
        t = dict(**cuda_stats(qk), non_pv_ms=cuda_ms(lambda: qk(False)),
                 plain_ms=cuda_ms(qp, iters=3, warmup=1), flops=4 * D * pairs, bytes=nbytes,
                 ops_ms=4 * D * pairs / H100_INT8_OPS * 1e3,
                 bytes_ms=nbytes / H100_HBM_BYTES * 1e3, library_ms=None,
                 library="none: no single PyTorch call computes int8 attention")
        bound(t)
        res["timing"] = t
        emit({"phase": "pv_int8_check", **res})
        results.append(res)
        lines["quant_attn_fwd"].append(
            {"shape": shape + ", pv_int8", **{key: t[key] for key in (
                "ms", "ms_min", "ms_max", "non_pv_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}, "relerr_out": res["relerr_out"], "max_abs_lse": res["max_abs_lse"]})
        del q, k, v, qts, qt_q, qt_k, qt_v, corr
        torch.cuda.empty_cache()
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"pv_int8 kernels disagree with their plain versions: {bad}")

    # The accuracy cell (bench.py:852-884): int8 and int8 pv_int8 through
    # quantized_flash_attention against fp64 attention.
    b, h, s = 2, 16, 4096
    x = [torch.randn((b, h, s, D), generator=gen).to(dev, torch.bfloat16) for _ in "qkv"]
    sc = torch.matmul(x[0].double(), x[1].double().transpose(-1, -2)) * D ** -0.5
    ref = torch.matmul(torch.softmax(sc, dim=-1), x[2].double())
    del sc
    int8 = QuantizationConfig(q_precision=Precision.INT8, k_precision=Precision.INT8,
                              v_precision=Precision.INT8)
    acc = {"phase": "pv_int8_accuracy", "shape": f"B{b} H{h} S{s} D{D} non-causal bf16 iid N(0, 1)",
           "reference": "fp64 attention", "v5e_history": {"int8": 0.0113, "int8_pv": 0.0159},
           "tol_pv": 0.02}
    for key, cfg in (("int8", int8), ("int8_pv", dc.replace(int8, pv_int8=True))):
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        out = qa.quantized_flash_attention(*x, config=cfg)
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
        acc[key] = rel_err(out.double(), ref)
        acc[f"{key}_launches"] = counts
        path_counts.append(counts)
    emit(acc)
    if not (acc["int8_pv"] < 0.02 and acc["int8_pv_launches"].get("fused_qattn/pv") == 1):
        raise AssertionError(f"pv_int8 accuracy cell: {acc}")
    del x, ref, out
    torch.cuda.empty_cache()
    record["pv_int8"] = {"checks": results, "accuracy": acc}
    return lines, worst, path_counts


def quant_step_want(recipe, depth):
    """Launches per quantized training step: one forward kernel and the two
    backward kernels per layer, and nothing of the other routes. A dense Q
    and ASYMMETRIC residuals take the dense backward (fp32, 3xTF32)."""
    zero = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "quant_bwd_dq", "quant_bwd_dkv",
            "quant_rows", "quant_attn_fwd")
    dense = recipe == "int8-qdense" or recipe.endswith("-asym")
    bwd = ("flash_bwd_dq", "flash_bwd_dkv") if dense else ("quant_bwd_dq", "quant_bwd_dkv")
    pv = {"fused_qattn/pv": depth} if recipe.endswith("-pv") else {}
    return {k: depth if k in bwd else 0 for k in zero} | {"fused_qattn": depth} | pv


def phase_quant_training(record):
    """The full-width model trains with cfg.quantization: int8 (a warm-up and
    three timed SGD steps), int4, int8-qdense, int8 and int4 with BLOCK
    scales and int8 ASYMMETRIC (a warm-up and one each: a recipe's first
    step also pays its allocations and first launches, 300 ms more in one
    run)."""
    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.models import gpt

    dev = torch.device("cuda")
    tokens = torch.randint(0, 32768, (B_TRAIN, S_TRAIN + 1),
                           generator=torch.Generator().manual_seed(5)).to(dev)
    out, path_counts = {}, []
    for recipe, n_steps in (("int8", 4), ("int4", 2), ("int8-qdense", 2), ("int8-block", 2),
                            ("int4-block", 2), ("int8-asym", 2), ("int8-pv", 4)):
        cfg = gpt.GPTConfig(vocab=32768, dim=1024, num_heads=HQ, num_kv_heads=HKV, depth=8,
                            max_seq=SK, dtype="bfloat16", quantization=quant_config(recipe))
        model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
        want = quant_step_want(recipe, cfg.depth)
        steps = []
        for i in range(n_steps):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            loss = loss_fn(model, tokens)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            with torch.no_grad():
                for prm in model.parameters():
                    prm -= TRAIN_LR * prm.grad
                    prm.grad = None
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            counts = dict(_kernels.launches)
            step = {"phase": "quant_training", "recipe": recipe, "step": i,
                    "warmup": i == 0 and n_steps > 1, "loss": loss.item(),
                    "fwd_ms": (t1 - t0) * 1e3, "bwd_ms": (t2 - t1) * 1e3,
                    "sgd_ms": (t3 - t2) * 1e3, "step_ms": (t3 - t0) * 1e3,
                    "tokens_per_s": B_TRAIN * S_TRAIN / (t3 - t0),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts}
            del loss
            emit(step)
            steps.append(step)
            if not step["warmup"]:
                path_counts.append(counts)
            if not math.isfinite(step["loss"]) or (i > 0 and not step["loss"] < steps[i - 1]["loss"]):
                raise AssertionError(f"{recipe} training step {i}: loss {step['loss']} is not "
                                     f"finite and below the step before's")
            if {k: counts.get(k, 0) for k in want} != want:
                raise AssertionError(f"{recipe} training step {i}: launches {counts}, "
                                     f"expected {want}")
        out[recipe] = steps
        del model
        torch.cuda.empty_cache()
    # pv_int8 on the two-pass route once: rows 6 (Q and K) and 5's PV
    # instantiation forward, rows 8-9 on V's per-tile BLOCK scales.
    cfg = gpt.GPTConfig(vocab=32768, dim=1024, num_heads=HQ, num_kv_heads=HKV, depth=8,
                        max_seq=SK, dtype="bfloat16", quantization=quant_config("int8-pv"))
    model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    want = {"quant_rows": 2 * cfg.depth, "quant_attn_fwd": cfg.depth,
            "quant_attn_fwd/pv": cfg.depth, "quant_bwd_dq": cfg.depth,
            "quant_bwd_dkv": cfg.depth, "fused_qattn": 0, "flash_fwd": 0}
    os.environ["UMFA_DISABLE_FUSED_QUANT"] = "1"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss = loss_fn(model, tokens)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = dict(_kernels.launches)
    finally:
        os.environ.pop("UMFA_DISABLE_FUSED_QUANT")
    step = {"phase": "quant_training", "recipe": "int8-pv", "route": "two-pass", "step": 0,
            "loss": loss.item(), "fwd_ms": (t1 - t0) * 1e3, "bwd_ms": (t2 - t1) * 1e3,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts}
    emit(step)
    out["int8-pv two-pass"] = [step]
    path_counts.append(counts)
    if not math.isfinite(step["loss"]) or {k: counts.get(k, 0) for k in want} != want:
        raise AssertionError(f"int8-pv two-pass training step: {step}, expected {want}")
    del model, loss
    torch.cuda.empty_cache()
    record["quant_training"] = {"batch": B_TRAIN, "seq": S_TRAIN, "lr": TRAIN_LR, "steps": out}
    del tokens
    torch.cuda.empty_cache()
    return path_counts


def phase_two_pass(record):
    """attention() under a quantization mode, on the card against the CPU
    path, with exact launches: int8 through the two-pass route (quant_rows
    three times, quant_attn_fwd once, then the STE backward kernels), with
    UMFA_DISABLE_FUSED_QUANT=1 (D 64 and 63) and causal with Sq 512 against
    Sk 1024; on the two-pass route also the int4 recipe (INT4 Q and K, the
    Q-mean corr row), ASYMMETRIC int8 (quantized by plain torch, as the
    reference does; the dense fp32 backward) and BLOCK int8 (plain torch
    quantizer, the quantized backward); then set_quantization_mode("int8",
    "block") and HYBRID on data that picks BLOCK, both single-launch."""
    import dataclasses as dc

    import torch

    import umfa_tpu_torch as ut
    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.engine.config import QuantMode
    from umfa_tpu_torch.utils.testing import rel_err

    gen = torch.Generator().manual_seed(10)
    b = B_CHECK
    two_pass = {"UMFA_DISABLE_FUSED_QUANT": "1"}
    rows_q = {"quant_rows": 3, "quant_attn_fwd": 1, "quant_bwd_dq": 1, "quant_bwd_dkv": 1,
              "fused_qattn": 0}
    plain_q = dict(rows_q, quant_rows=0)
    fused = {"fused_qattn": 1, "quant_bwd_dq": 1, "quant_bwd_dkv": 1, "quant_rows": 0,
             "quant_attn_fwd": 0}
    calls = [  # name, Sq, env, D, config, launches
        ("disable_fused_quant", 1024, two_pass, D, "int8", rows_q),
        ("causal_sq512_sk1024", 512, {}, D, "int8", rows_q),
        # a head_dim that is not a multiple of 4: quant_attn_fwd on codes
        # zero-padded to 64
        ("disable_fused_quant_d63", 1024, two_pass, 63, "int8", rows_q),
        ("two_pass_int4_recipe", 1024, two_pass, D, "int4", rows_q),
        ("two_pass_int8_asym", 1024, two_pass, D, "int8-asym",
         dict(plain_q, quant_bwd_dq=0, quant_bwd_dkv=0, flash_bwd_dq=1, flash_bwd_dkv=1)),
        ("two_pass_int8_block", 1024, two_pass, D, "int8-block", plain_q),
        ("fused_int8_block", 1024, {}, D, "int8-block", fused),
        ("fused_hybrid_picks_block", 1024, {}, D, "hybrid", fused),
    ]
    results, path_counts = [], []
    for name, sq, env, d, recipe, want_counts in calls:
        q = torch.randn((b, HQ, sq, d), generator=gen)
        if recipe == "hybrid":
            q[:, :, 7] *= 1000.0  # one outlier row: HYBRID picks BLOCK
            cfg = dc.replace(quant_config("int8"), mode=QuantMode.HYBRID)
        else:
            cfg = quant_config(recipe)
        k, v = torch.randn((b, HKV, 1024, d), generator=gen), torch.randn((b, HKV, 1024, d), generator=gen)
        w = torch.randn(q.shape, generator=gen)
        got = {}
        os.environ.update(env)
        try:
            for dev in ("cuda", "cpu"):
                t = [x.to(dev, copy=True).requires_grad_(True) for x in (q, k, v)]
                if dev == "cuda":
                    torch.cuda.synchronize()
                    _kernels.reset_launch_counts()
                with ut.use_quantization(config=cfg):
                    o = ut.attention(*t, is_causal=True)
                (o * w.to(dev)).sum().backward()
                if dev == "cuda":
                    torch.cuda.synchronize()
                    counts = dict(_kernels.launches)
                got[dev] = [o.detach().cpu()] + [x.grad.cpu() for x in t]
        finally:
            for key in env:
                os.environ.pop(key)
        errs = {n: rel_err(a, c) for n, a, c in zip(("out", "dq", "dk", "dv"), got["cuda"],
                                                     got["cpu"])}
        res = {"phase": "two_pass_route", "case": name, "shape": f"B{b} Hq{HQ} Hkv{HKV} "
               f"Sq{sq} Sk1024 D{d} causal fp32 {recipe}", "relerr": errs, "tol": 1e-2,
               "launches": counts}
        emit(res)
        results.append(res)
        path_counts.append(counts)
        if not all(e <= 1e-2 for e in errs.values()):
            raise AssertionError(f"two-pass route on the card differs from the CPU: {errs}")
        if {k_: counts.get(k_, 0) for k_ in want_counts} != want_counts:
            raise AssertionError(f"{name}: launches {counts}, expected {want_counts}")
    record["two_pass"] = results
    return path_counts


def phase_small_quant_training(record):
    """A small fp32 model with cfg.quantization (int8, int4, int8 BLOCK, int8
    ASYMMETRIC): the loss and every gradient on the card against the plain
    path on the CPU."""
    import torch

    from umfa_tpu_torch.models import gpt
    from umfa_tpu_torch.utils.testing import rel_err

    tokens = torch.randint(0, 64, (2, 97), generator=torch.Generator().manual_seed(11))
    out = {}
    for recipe in ("int8", "int4", "int8-block", "int8-asym"):
        cfg = gpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2, max_seq=96,
                            quantization=quant_config(recipe))
        res = {}
        for dev in ("cuda", "cpu"):
            model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
            loss = loss_fn(model, tokens.to(dev))
            loss.backward()
            res[dev] = (loss.item(), {n: prm.grad.cpu() for n, prm in model.named_parameters()})
        errs = {n: rel_err(res["cuda"][1][n], g) for n, g in res["cpu"][1].items()}
        r = {"phase": "small_quant_training_vs_cpu", "recipe": recipe, "loss_cuda": res["cuda"][0],
             "loss_cpu": res["cpu"][0],
             "loss_relerr": abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0]),
             "grads": len(errs), "worst_grad_relerr": max(errs.values()), "tol_loss": 1e-3,
             "tol_grad": 1e-2}
        emit(r)
        out[recipe] = r | {"grad_relerr": errs}
        if not (r["loss_relerr"] <= 1e-3 and r["worst_grad_relerr"] <= 1e-2):
            raise AssertionError(f"small quantized training on the card differs from the CPU: {r}")
    record["small_quant_training"] = out


def phase_quant_attention_api(record):
    """attention() under int8 and int4 on the card with a float bias that
    requires grad and bias_grad=True, against the CPU path."""
    import torch

    import umfa_tpu_torch as ut
    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.utils.testing import rel_err

    gen = torch.Generator().manual_seed(12)
    b, s = B_CHECK, 1024
    q, k, v = (torch.randn(shape, generator=gen) for shape in
               ((b, HQ, s, D), (b, HKV, s, D), (b, HKV, s, D)))
    bias = torch.randn((1, HQ, s, s), generator=gen)
    w = torch.randn((b, HQ, s, D), generator=gen)
    grads = {}
    for dev in ("cuda", "cpu"):
        ut.reset_dispatch_stats()
        if dev == "cuda":
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
        for recipe in ("int8", "int4"):
            t = [x.to(dev, copy=True).requires_grad_(True) for x in (q, k, v, bias)]
            with ut.use_quantization(recipe):
                out = ut.attention(*t[:3], t[3], is_causal=True, bias_grad=True)
            (out * w.to(dev)).sum().backward()
            grads[dev, recipe] = [x.grad.cpu() for x in t]
        if dev == "cuda":
            torch.cuda.synchronize()
            counts, stats = dict(_kernels.launches), ut.get_dispatch_stats()
    checks = {f"{r}/{g}": rel_err(a, c)
              for r in ("int8", "int4")
              for g, a, c in zip(("dq", "dk", "dv", "dbias"), grads["cuda", r], grads["cpu", r])}
    out = {"phase": "quant_attention_api", "shape": f"B{b} Hq{HQ} Hkv{HKV} S{s} D{D} fp32",
           "relerr": checks, "tol": 1e-2, "launches": counts, "dispatch": stats}
    emit(out)
    record["quant_attention_api"] = out
    if not all(e <= 1e-2 for e in checks.values()):
        raise AssertionError(f"quantized attention() on the card differs from the CPU: {checks}")
    if stats["quantized_autograd"] != 2 or stats["naive_fallback"] != 0:
        raise AssertionError(f"quantized attention() took another route: {stats}")
    if counts.get("flash_dbias", 0) != 2 or counts.get("fused_qattn", 0) != 2:
        raise AssertionError(f"quantized attention() did not go through the kernels: {counts}")
    return counts


RING_N, RING_S = 4, 4096  # the full-width ring: B_TRAIN x S 4096 over LocalRing(4)
RING_LAYOUTS = {"causal": (True, False), "zigzag": (True, True), "full": (False, False)}
# Per layout of the full-width ring: launches of each ring kernel, and hops.
RING_EXPECTED = {
    "causal": (10, {"fwd_kv": 6, "bwd_kv": 12, "bwd_dkv": 12, "bwd_home": 4}),
    "zigzag": (16, {"fwd_kv": 12, "bwd_kv": 12, "bwd_dkv": 12, "bwd_home": 4}),
}
PROBE_REPS = 1024


def ring_loss(out, lse, w):
    """The ring phases' loss: sum(out · cos out) (tests/test_parallel.py:180-185)
    plus a term on LSE, so that the backward also takes an LSE cotangent."""
    import torch

    o = out.float()
    return (o * torch.cos(o)).sum() + (lse * w).sum()


def phase_ring_kernels(record):
    """Rows 11-12: the ring with its kernels (`ring_fwd_step`,
    `ring_bwd_dkv`, `ring_bwd_dq`) against the same ring with their plain
    versions, both on the card over LocalRing, at B2, Hq16/Hkv8 and Hq =
    Hkv = 8, S 1024 over 4 and 2 ranks, D 64 and 128, fp32 and bf16,
    contiguous causal, zigzag causal and non-causal, the backward with a
    nonzero dlse; a local chunk of 96, and bf16 and fp32 D 256, over 4
    ranks; then the two backward routes against each other."""
    import torch

    from umfa_tpu_torch.parallel import LocalRing, ring_flash_attention_pallas
    from umfa_tpu_torch.parallel import ring_pallas as rp
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(11)
    fwd_tol = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-2, 1e-3)}
    bwd_tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = {"ring_fwd_step": 0.0, "ring_bwd_dkv": 0.0, "ring_bwd_dq": 0.0}
    results = []
    for hq, hkv in ((HQ, HKV), (HKV, HKV)):
        for n in (4, 2):
            for d in (64, 128):
                for layout, (causal, zigzag) in RING_LAYOUTS.items():
                    for dtype in (torch.float32, torch.bfloat16):
                        shapes = ((B_CHECK, hq, 1024, d), (B_CHECK, hkv, 1024, d),
                                  (B_CHECK, hkv, 1024, d), (B_CHECK, hq, 1024, d))
                        q, k, v, do = (torch.randn(s, generator=gen).to(dev, dtype)
                                       for s in shapes)
                        dlse = torch.randn((B_CHECK, hq, 1024), generator=gen).to(dev)
                        cfg = rp._config(1024 // n, causal, zigzag, d**-0.5, None)
                        out, lse = rp._ring_fwd(q, k, v, LocalRing(n), cfg)
                        grads = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(n), cfg)
                        torch.cuda.synchronize()
                        want, want_lse = rp._ring_fwd(q, k, v, LocalRing(n), cfg, plain=True)
                        want_grads = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(n), cfg,
                                                  plain=True)
                        res = {"case": f"Hq{hq} Hkv{hkv} n{n} D{d} {layout} {str(dtype)[6:]}",
                               "relerr_out": rel_err(out, want),
                               "max_abs_lse": float((lse - want_lse).abs().max()),
                               "finite": all(torch_isfinite(t) for t in (out, lse, *grads))}
                        for g, x, y in zip(("dq", "dk", "dv"), grads, want_grads):
                            res[f"relerr_{g}"] = rel_err(x, y)
                        rtol, ltol = fwd_tol[dtype]
                        res["ok"] = (res["finite"] and res["relerr_out"] <= rtol
                                     and res["max_abs_lse"] <= ltol
                                     and all(res[f"relerr_{g}"] <= bwd_tol[dtype]
                                             for g in ("dq", "dk", "dv")))
                        abs_err = [float((x.float() - y.float()).abs().max())
                                   for x, y in zip((out, *grads), (want, *want_grads))]
                        worst["ring_fwd_step"] = max(worst["ring_fwd_step"], abs_err[0])
                        worst["ring_bwd_dq"] = max(worst["ring_bwd_dq"], abs_err[1])
                        worst["ring_bwd_dkv"] = max(worst["ring_bwd_dkv"], *abs_err[2:])
                        results.append(res)
    # A local chunk of 96 rows (zigzag halves of 48: ragged tiles) and D 256
    # (bf16, and fp32 on the wide 3xTF32 tiles), contiguous and zigzag
    # causal, over 4 ranks.
    extra = [(seq, d, dtype, layout) for seq, d in ((384, 64), (1024, 256))
             for dtype in (torch.float32, torch.bfloat16) for layout in ("causal", "zigzag")]
    for seq, d, dtype, layout in extra:
        causal, zigzag = RING_LAYOUTS[layout]
        shapes = ((B_CHECK, HQ, seq, d), (B_CHECK, HKV, seq, d), (B_CHECK, HKV, seq, d),
                  (B_CHECK, HQ, seq, d))
        q, k, v, do = (torch.randn(s, generator=gen).to(dev, dtype) for s in shapes)
        dlse = torch.randn((B_CHECK, HQ, seq), generator=gen).to(dev)
        cfg = rp._config(seq // 4, causal, zigzag, d**-0.5, None)
        out, lse = rp._ring_fwd(q, k, v, LocalRing(4), cfg)
        grads = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(4), cfg)
        torch.cuda.synchronize()
        want, want_lse = rp._ring_fwd(q, k, v, LocalRing(4), cfg, plain=True)
        want_grads = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(4), cfg, plain=True)
        res = {"case": f"Hq{HQ} Hkv{HKV} n4 S_loc{seq // 4} D{d} {layout} {str(dtype)[6:]}",
               "relerr_out": rel_err(out, want),
               "max_abs_lse": float((lse - want_lse).abs().max()),
               "finite": all(torch_isfinite(t) for t in (out, lse, *grads))}
        for g, x, y in zip(("dq", "dk", "dv"), grads, want_grads):
            res[f"relerr_{g}"] = rel_err(x, y)
        rtol, ltol = fwd_tol[dtype]
        res["ok"] = (res["finite"] and res["relerr_out"] <= rtol and res["max_abs_lse"] <= ltol
                     and all(res[f"relerr_{g}"] <= bwd_tol[dtype] for g in ("dq", "dk", "dv")))
        abs_err = [float((x.float() - y.float()).abs().max())
                   for x, y in zip((out, *grads), (want, *want_grads))]
        worst["ring_fwd_step"] = max(worst["ring_fwd_step"], abs_err[0])
        worst["ring_bwd_dq"] = max(worst["ring_bwd_dq"], abs_err[1])
        worst["ring_bwd_dkv"] = max(worst["ring_bwd_dkv"], *abs_err[2:])
        results.append(res)
    record["ring_kernel_checks"] = results
    summary = {"phase": "ring_kernel_check", "cases": len(results),
               "gates": "fwd fp32 2e-5 (LSE 1e-5), bf16 1e-2 (LSE 1e-3); bwd fp32 1e-4, bf16 2e-2",
               "failed": [r["case"] for r in results if not r["ok"]]}
    for dt in ("float32", "bfloat16"):
        rows = [r for r in results if r["case"].endswith(dt)]
        summary[f"worst_{dt}"] = {key: max(r[key] for r in rows) for key in
                                  ("relerr_out", "max_abs_lse", "relerr_dq", "relerr_dk",
                                   "relerr_dv")}
    emit(summary)
    if summary["failed"]:
        raise AssertionError(f"ring kernels disagree with their plain versions: {summary['failed']}")

    # The kernel backward against the reference's A/B route (UMFA_RING_BWD=jnp:
    # a ring of the dense backward kernels), fp32, through autograd.
    routes = {}
    for layout in ("causal", "zigzag"):
        zigzag = RING_LAYOUTS[layout][1]
        q = torch.randn((B_CHECK, HQ, 1024, D), generator=gen).to(dev)
        k, v = (torch.randn((B_CHECK, HKV, 1024, D), generator=gen).to(dev) for _ in range(2))
        w = torch.randn((B_CHECK, HQ, 1024), generator=gen).to(dev)
        grads = {}
        for route in ("pallas", "jnp"):
            os.environ["UMFA_RING_BWD"] = route
            try:
                leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
                out, lse = ring_flash_attention_pallas(*leaves, ring=LocalRing(4), causal=True,
                                                       zigzag=zigzag, return_lse=True)
                ring_loss(out, lse, w).backward()
                grads[route] = [x.grad for x in leaves]
            finally:
                del os.environ["UMFA_RING_BWD"]
        routes[layout] = max(rel_err(a, b) for a, b in zip(grads["pallas"], grads["jnp"]))
    emit({"phase": "ring_backward_routes", "relerr_fp32": routes, "gate": 2e-5})
    record["ring_backward_routes"] = routes
    if max(routes.values()) > 2e-5:
        raise AssertionError(f"the two ring backward routes disagree: {routes}")
    return worst


def phase_ring_selfloop(record):
    """The reference's one-device protocol checks at their defaults (B1 H2
    S1024 D128 bf16): one rank sends its own chunk to itself for n_steps;
    only step 0 computes. Each check asserts its hops (n_steps - 1 per
    buffer); here each ring kernel must launch exactly once."""
    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.parallel import ring_pallas as rp

    out = []
    for n_steps, causal in ((4, True), (3, False)):
        before = collections.Counter(_kernels.launches)
        rel, _, _ = rp.ring_pallas_selfloop_check(n_steps=n_steps, causal=causal)
        mid = collections.Counter(_kernels.launches)
        rel_bwd = rp.ring_pallas_selfloop_bwd_check(n_steps=n_steps, causal=causal)
        after = collections.Counter(_kernels.launches)
        launches = {"ring_fwd_step": (mid - before)["ring_fwd_step"],
                    "ring_bwd_dkv": (after - mid)["ring_bwd_dkv"],
                    "ring_bwd_dq": (after - mid)["ring_bwd_dq"]}
        res = {"phase": "ring_selfloop", "n_steps": n_steps, "causal": causal,
               "relerr_fwd": rel, "gate_fwd": 5e-3, "relerr_bwd": rel_bwd, "gate_bwd": 2e-2,
               "hops_per_buffer": n_steps - 1, "launches": launches}
        emit(res)
        out.append(res)
        if set(launches.values()) != {1}:
            raise AssertionError(f"self-loop ring launched {launches}, expected one of each")
    record["ring_selfloop"] = out


# The ring's kernels by the names the trace gives them: the tensor-core
# bodies of the forward and backward steps (no other kernel of these names
# runs while the ring is driven).
RING_TRACE_KERNELS = ("fwd_tc_kernel", "dkv_tc_kernel", "dq_tc_kernel")


def cuda_trace_overlap(fn, path):
    """Device copies of `fn` on other streams than its ring kernels, and how
    much of their time ran while a ring kernel ran (torch.profiler trace,
    written to `path`). None where the trace shows no ring kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"
               and any(k in e.get("name", "") for k in RING_TRACE_KERNELS)]
    if not kernels:
        return None
    streams = {e.get("args", {}).get("stream") for e in kernels}
    copies = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "gpu_memcpy"
              and e.get("args", {}).get("stream") not in streams]
    busy = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    overlap = sum(max(0.0, min(b, y) - max(a, x)) for a, b in copies for x, y in busy)
    copy_us = sum(b - a for a, b in copies)
    return {"side_stream_copies": len(copies), "copy_ms": copy_us / 1e3,
            "overlapped_ms": overlap / 1e3,
            "overlapped_share": overlap / copy_us if copy_us else None,
            "ring_kernel_ms": sum(e["dur"] for e in kernels) / 1e3}


def phase_ring_full(record):
    """The ring at full width: B8 Hq16 Hkv8 S4096 D64 bf16 over LocalRing(4),
    contiguous causal and zigzag causal, forward and `.backward()` of
    `ring_loss`, against single-device `flash_attention` (rows 1-3) on the
    unsharded sequence; exact launch and hop counts around the ring's own
    run; each ring kernel timed at this shape; the whole ring beside the
    port's flash kernels and SDPA on the unsharded sequence; the hops' copy
    time and their overlap with the ring kernels."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.ops.attention import flash_attention
    from umfa_tpu_torch.ops.flash_bwd import flash_attention_backward
    from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward
    from umfa_tpu_torch.parallel import LocalRing, ring_flash_attention_pallas, zigzag_shard
    from umfa_tpu_torch.parallel import ring_pallas as rp
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    b, s, n = B_TRAIN, RING_S, RING_N
    s_loc, scale = s // n, D**-0.5
    gen = torch.Generator().manual_seed(12)
    q = torch.randn((b, HQ, s, D), generator=gen).to(dev, torch.bfloat16)
    k, v = (torch.randn((b, HKV, s, D), generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    w = torch.randn((b, HQ, s), generator=gen).to(dev)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref_out, ref_lse = flash_attention(*leaves, causal=True, return_lse=True)
    ring_loss(ref_out, ref_lse, w).backward()
    ref = {"out": ref_out.detach(), "lse": ref_lse.detach(),
           **{g: x.grad for g, x in zip(("dq", "dk", "dv"), leaves)}}
    del leaves, ref_out, ref_lse

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    path_counts, runs, traces = [], {}, {}
    for layout, (launches_want, hops_want) in RING_EXPECTED.items():
        zigzag = RING_LAYOUTS[layout][1]
        lay = (lambda x: zigzag_shard(x, n)) if zigzag else (lambda x: x)
        lq, lk, lv, lw = (lay(x) for x in (q, k, v, w))

        def drive(ring, lq=lq, lk=lk, lv=lv, lw=lw, zigzag=zigzag):
            leaves = [x.clone().requires_grad_(True) for x in (lq, lk, lv)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, lse = ring_flash_attention_pallas(*leaves, ring=ring, causal=True, zigzag=zigzag,
                                                   return_lse=True)
            loss = ring_loss(out, lse, lw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            return (out.detach(), lse.detach(), [x.grad for x in leaves],
                    (t1 - t0) * 1e3, (t2 - t1) * 1e3)

        drive(LocalRing(n))  # warm-up: one-time CUDA set-up stays out of the times
        ring = LocalRing(n)
        _kernels.reset_launch_counts()
        out, lse, grads, fwd_ms, bwd_ms = drive(ring)
        counts = dict(_kernels.launches)
        path_counts.append(counts)
        res = {"phase": "ring_full_width", "layout": layout,
               "shape": f"B{b} Hq{HQ} Hkv{HKV} S{s} D{D} bf16, LocalRing({n}), causal",
               "forward_ms": fwd_ms, "backward_ms": bwd_ms,
               "relerr_out": rel_err(out, lay(ref["out"])),
               "max_abs_lse": float((lse - lay(ref["lse"])).abs().max()),
               **{f"relerr_{g}": rel_err(x, lay(ref[g])) for g, x in zip(("dq", "dk", "dv"), grads)},
               "finite": all(torch_isfinite(t) for t in (out, lse, *grads)),
               "launches": counts, "hops": dict(ring.hops)}
        traces[layout] = cuda_trace_overlap(
            lambda: drive(LocalRing(n)),
            os.path.join(REPO, "chiprun_out", f"ring_trace_{layout}.json"))
        res["hop_overlap"] = traces[layout]
        emit(res)
        runs[layout] = res
        del out, lse, grads
        torch.cuda.empty_cache()
        want_counts = {name: launches_want for name in ("ring_fwd_step", "ring_bwd_dkv",
                                                        "ring_bwd_dq")}
        if counts != want_counts:
            raise AssertionError(f"{layout} ring launched {counts}, expected {want_counts}")
        if dict(ring.hops) != hops_want:
            raise AssertionError(f"{layout} ring made hops {dict(ring.hops)}, expected {hops_want}")
        if not (res["finite"] and res["relerr_out"] <= 1e-2
                and all(res[f"relerr_{g}"] <= 2e-2 for g in ("dq", "dk", "dv"))):
            raise AssertionError(f"{layout} ring disagrees with flash_attention: {res}")
    record["ring_full_width"] = runs

    # Each kernel at this shape, on rank 3's chunk: against chunk 2 (every
    # pair visible) and against its own chunk (the causal diagonal).
    cfg = rp._config(s_loc, True, False, scale, None)
    chunk = lambda x, i: x.chunk(n, dim=2)[i].contiguous()  # noqa: E731
    q3, k2, v2, k3, v3 = chunk(q, 3), chunk(k, 2), chunk(v, 2), chunk(k, 3), chunk(v, 3)
    do3 = torch.randn(q3.shape, generator=gen).to(dev, torch.bfloat16)
    lse3 = chunk(ref["lse"], 3)
    delta3 = rp._delta(chunk(ref["out"], 3), do3, chunk(w, 3))
    full = rp._Step(n, 3, 2, False, True, False, scale, cfg.block_k)
    diag = rp._Step(n, 3, 3, True, True, False, scale, cfg.block_k)
    o3, l3 = torch.empty_like(q3), torch.empty(lse3.shape, device=dev)
    rp.ring_fwd_step(q3, k3, v3, o3, l3, diag)
    q3f, k2f, v2f, o3f = q3.float(), k2.float(), v2.float(), o3.float()
    dk, dv, dq = (torch.zeros(x.shape, device=dev) for x in (k2, v2, q3))
    pairs_full = b * HQ * s_loc * s_loc
    pairs_diag = b * HQ * s_loc * (s_loc + 1) // 2
    qkv_bytes = 2 * (q3.numel() + k2.numel() + v2.numel())
    bwd_reads = qkv_bytes + 2 * do3.numel() + 4 * (lse3.numel() + delta3.numel())
    kernels = {  # name: (kernel, plain, flops, bytes, outputs to compare, bf16 gate)
        "ring_fwd_step": (lambda: rp.ring_fwd_step(q3, k2, v2, o3, l3, full),
                          lambda: rp._fwd_step_plain(q3, k2, v2, o3, l3, full),
                          4 * D * pairs_full, qkv_bytes + 2 * 2 * o3.numel() + 2 * 4 * l3.numel(),
                          (o3, l3), 1e-2),
        "ring_fwd_step_diagonal": (lambda: rp.ring_fwd_step(q3, k3, v3, o3, l3, diag),
                                   lambda: rp._fwd_step_plain(q3, k3, v3, o3, l3, diag),
                                   4 * D * pairs_diag, qkv_bytes + 2 * o3.numel() + 4 * l3.numel(),
                                   (o3, l3), 1e-2),
        "ring_fwd_step_fp32": (lambda: rp.ring_fwd_step(q3f, k2f, v2f, o3f, l3, full),
                               lambda: rp._fwd_step_plain(q3f, k2f, v2f, o3f, l3, full),
                               4 * D * pairs_full,
                               2 * qkv_bytes + 2 * 4 * o3f.numel() + 2 * 4 * l3.numel(),
                               (o3f, l3), 2e-5),
        "ring_bwd_dkv": (lambda: rp.ring_bwd_dkv(q3, do3, lse3, delta3, k2, v2, dk, dv, full),
                         lambda: rp._dkv_plain(q3, do3, lse3, delta3, k2, v2, dk, dv, full),
                         8 * D * pairs_full, bwd_reads + 2 * 4 * (dk.numel() + dv.numel()),
                         (dk, dv), 2e-2),
        "ring_bwd_dq": (lambda: rp.ring_bwd_dq(q3, do3, lse3, delta3, k2, v2, dq, full),
                        lambda: rp._dq_plain(q3, do3, lse3, delta3, k2, v2, dq, full),
                        6 * D * pairs_full, bwd_reads + 2 * 4 * dq.numel(), (dq,), 2e-2),
    }
    # The three kernels on fp32 inputs at D 256 (the wide 3xTF32 tiles), the
    # same step of rank 3 against chunk 2.
    d2 = 256
    q3w, do3w = (torch.randn((b, HQ, s_loc, d2), generator=gen).to(dev) for _ in range(2))
    k2w, v2w = (torch.randn((b, HKV, s_loc, d2), generator=gen).to(dev) for _ in range(2))
    full2 = full._replace(scale=d2**-0.5)
    sw = torch.matmul(rp._fold(q3w * full2.scale, HKV), k2w.transpose(-1, -2))
    lse3w = sw.reshape(b, HQ, s_loc, s_loc).logsumexp(-1)  # finite on every row
    del sw
    delta3w = torch.randn(lse3w.shape, generator=gen).to(dev)
    o3w, l3w = torch.randn(q3w.shape, generator=gen).to(dev), lse3w.clone()
    dkw, dvw, dqw = (torch.zeros(x.shape, device=dev) for x in (k2w, v2w, q3w))
    wide_reads = 4 * (q3w.numel() + k2w.numel() + v2w.numel())
    kernels.update({
        "ring_fwd_step_fp32_d256": (
            lambda: rp.ring_fwd_step(q3w, k2w, v2w, o3w, l3w, full2),
            lambda: rp._fwd_step_plain(q3w, k2w, v2w, o3w, l3w, full2),
            4 * d2 * pairs_full, wide_reads + 2 * 4 * o3w.numel() + 2 * 4 * l3w.numel(),
            (o3w, l3w), 2e-5),
        "ring_bwd_dkv_fp32_d256": (
            lambda: rp.ring_bwd_dkv(q3w, do3w, lse3w, delta3w, k2w, v2w, dkw, dvw, full2),
            lambda: rp._dkv_plain(q3w, do3w, lse3w, delta3w, k2w, v2w, dkw, dvw, full2),
            8 * d2 * pairs_full,
            wide_reads + 4 * (do3w.numel() + 2 * lse3w.numel()) + 2 * 4 * (dkw.numel() + dvw.numel()),
            (dkw, dvw), 1e-4),
        "ring_bwd_dq_fp32_d256": (
            lambda: rp.ring_bwd_dq(q3w, do3w, lse3w, delta3w, k2w, v2w, dqw, full2),
            lambda: rp._dq_plain(q3w, do3w, lse3w, delta3w, k2w, v2w, dqw, full2),
            6 * d2 * pairs_full,
            wide_reads + 4 * (do3w.numel() + 2 * lse3w.numel()) + 2 * 4 * dqw.numel(),
            (dqw,), 1e-4),
    })
    timing = {}
    for name, (kern, plain, flops, nbytes, outs, gate) in kernels.items():
        fp32 = "_fp32" in name
        d_name = 256 if name.endswith("_d256") else D
        start = [x.clone() for x in outs]
        kern()
        got = [x.clone() for x in outs]
        for x, y in zip(outs, start):
            x.copy_(y)
        plain()
        check = max(rel_err(x, y) for x, y in zip(got, outs))
        # fp32: the 3xTF32 floor, three TF32 products for each fp32 one.
        ops_ms = (3 * flops / H100_TF32_FLOPS if fp32 else flops / H100_BF16_FLOPS) * 1e3
        t = dict(**cuda_stats(kern), plain_ms=cuda_ms(plain, iters=3, warmup=1),
                 flops=flops, bytes=nbytes, ops_ms=ops_ms,
                 bytes_ms=nbytes / H100_HBM_BYTES * 1e3, relerr_vs_plain=check, gate=gate,
                 library_ms=None,
                 library=("none: no single PyTorch call attends one chunk by global "
                          "positions and merges into (o, lse)"))
        bound(t)
        emit({"phase": "kernel_timing", "kernel": name,
              "shape": f"B{b} Hq{HQ} Hkv{HKV} S_loc{s_loc} D{d_name} {'fp32' if fp32 else 'bf16'}, "
                       f"rank 3 of {n}", **t})
        timing[name] = t
        if check > gate:
            raise AssertionError(f"{name} disagrees with its plain version at full width: {check}")
        del start, got
    del q3w, do3w, k2w, v2w, lse3w, delta3w, o3w, l3w, dkw, dvw, dqw, kernels
    torch.cuda.empty_cache()

    # The whole ring beside single-device attention on the unsharded sequence.
    do = torch.randn(q.shape, generator=gen).to(dev, torch.bfloat16)
    ring_out, ring_lse = rp._ring_fwd(q, k, v, LocalRing(n), cfg)
    whole = {
        "ring_forward_ms": cuda_ms(lambda: rp._ring_fwd(q, k, v, LocalRing(n), cfg), iters=5),
        "ring_backward_ms": cuda_ms(lambda: rp._ring_bwd(q, k, v, ring_out, ring_lse, do, w,
                                                         LocalRing(n), cfg), iters=5),
        "flash_fwd_ms": cuda_ms(lambda: flash_attention_forward(q, k, v, causal=True), iters=5),
        "flash_bwd_dq_dkv_ms": cuda_ms(lambda: flash_attention_backward(
            q, k, v, ref["out"], ref["lse"], do, None, w, causal=True, grad_dtype=torch.bfloat16),
            iters=5),
    }
    try:
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            whole["sdpa_forward_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        whole["sdpa_backward_ms"] = cuda_ms(
            lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True))
        del qg, kg, vg, o
    except (RuntimeError, TypeError) as e:
        whole["sdpa"] = f"not measured: this torch refused GQA flash SDPA ({e})"[:300]
    # One hop: a (2, B, Hkv, S_loc, D) bf16 slot copied on the card.
    slot = torch.empty((2, b, HKV, s_loc, D), dtype=torch.bfloat16, device=dev)
    slot2 = torch.empty_like(slot)
    whole["hop_ms"] = cuda_ms(lambda: slot2.copy_(slot))
    whole["hop_bytes"] = slot.numel() * 2
    whole["hop_overlap"] = traces
    emit({"phase": "ring_whole", "shape": f"B{b} Hq{HQ} Hkv{HKV} S{s} D{D} bf16, causal", **whole})
    record["ring_whole"] = whole
    del ring_out, ring_lse, do, slot, slot2, ref
    torch.cuda.empty_cache()
    return timing, path_counts


def phase_mma_probe(record):
    """Row 13: the tensor-core probe at the five shapes of scripts/d64_ab.py,
    against its plain version at reps 1 and 8 (fp32 relerr 1e-5) and the
    same bits on two calls, then at reps 1024 with its TFLOP/s beside the
    989 TFLOP/s datasheet peak, its plan (64 x tn tiles, K split, work
    items, blocks an SM holds, SMs used) and one cuBLAS product of the same
    shape (a yardstick only)."""
    import ctypes

    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.utils import mma_probe as mp
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = _kernels.function("mma_probe", "umfa_mma_probe_blocks_per_sm", (ctypes.c_int,) * 2)
    gen = torch.Generator().manual_seed(13)
    operands, rows, worst = {}, {}, 0.0
    for name, (m, k, n) in mp.SHAPES.items():
        a = torch.randn((m, k), generator=gen).to(dev, torch.bfloat16)
        b = (torch.randn((k, n), generator=gen) * 1e-3).to(dev, torch.bfloat16)
        operands[name] = (a, b)
        checks = {}
        for reps in (1, 8):
            got, want = mp.mma_probe(a, b, reps), mp.mma_probe_plain(a, b, reps)
            worst = max(worst, float((got - want).abs().max()))
            checks[f"relerr_reps{reps}"] = rel_err(got, want)
        same = bool(torch.equal(mp.mma_probe(a, b, 8), got))
        tn, split = mp.plan(m, k, n)
        items = (m // 64) * (n // tn) * split
        flops = 2 * m * k * n * PROBE_REPS
        ms = cuda_ms(lambda: mp.mma_probe(a, b, PROBE_REPS), iters=5, warmup=1)
        cublas_ms = cuda_ms(lambda: torch.mm(a, b))
        rows[name] = {"shape": f"M{m} K{k} N{n}", **checks, "same_bits_twice": same,
                      "tile": f"64x{tn}", "split": split, "slice_k": k // split,
                      "work_items": items, "blocks_per_sm": per_sm(tn, k // split // 16),
                      "sms_used": min(items, sms), "sms": sms, "ms": ms,
                      "tflops": flops / ms / 1e9, "share_of_989": flops / ms / 1e9 / 989,
                      "cublas_ms_one_product": cublas_ms,
                      "cublas_tflops": 2 * m * k * n / cublas_ms / 1e9}
        emit({"phase": "mma_probe", "name": name, "reps": PROBE_REPS, **rows[name]})
        if max(checks.values()) > 1e-5 or not same:
            raise AssertionError(f"mma_probe disagrees with its plain version at {name}: "
                                 f"{checks}, same bits twice {same}")
    record["mma_probe"] = rows

    # The probe's own path: each shape once at reps 1024.
    _kernels.reset_launch_counts()
    for a, b in operands.values():
        mp.mma_probe(a, b, PROBE_REPS)
    torch.cuda.synchronize()
    counts = dict(_kernels.launches)

    m, k, n = mp.SHAPES["mxu_deep"]
    a, b = operands["mxu_deep"]
    flops = 2 * m * k * n * PROBE_REPS
    nbytes = 2 * (a.numel() + b.numel()) + 4 * m * n
    t = dict(ms=rows["mxu_deep"]["ms"],
             plain_ms=cuda_ms(lambda: mp.mma_probe_plain(a, b, PROBE_REPS), iters=3, warmup=1),
             ops_ms=flops / H100_BF16_FLOPS * 1e3, bytes_ms=nbytes / H100_HBM_BYTES * 1e3,
             library_ms=None,
             library=("none: no single PyTorch call computes the reps loop; one cuBLAS product "
                      "per shape is in the mma_probe lines"))
    bound(t)
    emit({"phase": "kernel_timing", "kernel": "mma_probe",
          "shape": f"mxu_deep M{m} K{k} N{n}, reps {PROBE_REPS}", **t})
    return {"mma_probe": t}, {"mma_probe": worst}, counts


def phase_rope(record):
    """rope_attention(interleaved=False) through the ROPE instantiation of
    flash_fwd (Q and K rotated inside the kernel) and the dense backward
    kernels: at each of rope_attention's geometries (`utils/fwd_timing.py`
    ROPE_SHAPES) the kernel's out and LSE against its plain
    version (row 1's gates), then the path's forward and `.backward()` with
    exact launches (one flash_fwd, one flash_fwd/rope, one flash_bwd_dq, one
    flash_bwd_dkv) against the same path with every wrapper's plain version
    (`plain_kernels()`; out 1e-2 / gradients 2e-2 in bf16, out 2e-5 /
    gradients 1e-4 in fp32);
    then the in-kernel forward timed beside the two-pass route (apply_rope
    on Q and K, then flash_fwd) and SDPA on the pre-rotated operands (a
    yardstick only), with its bound."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.ops import flash_fwd as ff
    from umfa_tpu_torch.ops.rope import apply_rope, rope_angles, rope_attention
    from umfa_tpu_torch.utils.fwd_timing import ROPE_SHAPES
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(23)
    gates = {torch.float32: (2e-5, 1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-3, 2e-2)}
    want_counts = {"flash_fwd": 1, "flash_fwd/rope": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    runs, path_counts, worst = {}, [], 0.0
    for name, b, h, s, d, causal, dt in ROPE_SHAPES:
        dtype = getattr(torch, dt)
        fgate, lgate, bgate = gates[dtype]
        q, k, v, w = (torch.randn((b, h, s, d), generator=gen).to(dev, dtype) for _ in range(4))
        cos, sin = rope_angles(s, d, device=dev)
        kw = dict(causal=causal, rope_cos=cos, rope_sin=sin)
        got = ff.flash_attention_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        check = compare(f"rope/{dt}/{name}", got, ff.flash_attention_forward_plain(q, k, v, **kw),
                        fgate, lgate)
        worst = max(worst, check["max_abs_out"])
        del got

        def path():
            t = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = rope_attention(*t, cos, sin, interleaved=False, causal=causal)
            (out.float() * w.float()).sum().backward()
            return [out.detach()] + [x.grad for x in t]

        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        res = path()
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
        path_counts.append(counts)
        with plain_kernels():
            want = path()
        errs = {n: rel_err(a, bb) for n, a, bb in zip(("out", "dq", "dk", "dv"), res, want)}
        del res, want
        path_ok = errs["out"] <= fgate and all(errs[n] <= bgate for n in ("dq", "dk", "dv"))

        # Timing: the in-kernel forward, the two-pass route, SDPA on the
        # pre-rotated operands (flash backend for bf16, memory-efficient
        # for fp32).
        def two_pass():
            return ff.flash_attention_forward(apply_rope(q, cos, sin, interleaved=False),
                                              apply_rope(k, cos, sin, interleaved=False), v,
                                              causal=causal)

        qr, kr = (apply_rope(x, cos, sin, interleaved=False) for x in (q, k))
        backend = SDPBackend.FLASH_ATTENTION if dtype == torch.bfloat16 else (
            SDPBackend.EFFICIENT_ATTENTION)
        with sdpa_kernel(backend):
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v,
                                                                        is_causal=causal))
        del qr, kr
        pairs = b * h * visible_pairs(s, s, -1, 0 if causal else -1)
        flops = 4 * d * pairs + 6 * b * h * s * d  # the products, and the two rotations
        nbytes = q.element_size() * 4 * q.numel() + b * h * s * 4 + 2 * cos.numel() * 4
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_TF32_FLOPS / 3
        t = dict(**cuda_stats(lambda: ff.flash_attention_forward(q, k, v, **kw)),
                 two_pass_ms=cuda_ms(two_pass),
                 plain_ms=cuda_ms(lambda: ff.flash_attention_forward_plain(q, k, v, **kw),
                                  iters=3, warmup=1),
                 library_ms=library_ms, flops=flops, bytes=nbytes,
                 ops_ms=flops / peak * 1e3, bytes_ms=nbytes / H100_HBM_BYTES * 1e3)
        bound(t)
        t["library"] = (f"{'flash' if dtype == torch.bfloat16 else 'memory-efficient'} SDPA "
                        "forward on the pre-rotated Q and K")
        r = {"phase": "rope", "case": name,
             "shape": f"B{b} H{h} S{s} D{d} {'causal' if causal else 'non-causal'} {dt}",
             "kernel_check": check, "path_relerr": errs, "path_launches": counts,
             "path_ok": path_ok, **t}
        emit(r)
        runs[name] = r
        if not check["ok"]:
            raise AssertionError(f"the ROPE flash_fwd disagrees with its plain version: {check}")
        if {key: counts.get(key, 0) for key in want_counts} != want_counts or any(
                n for key, n in counts.items() if key not in want_counts):
            raise AssertionError(f"rope_attention {name}: launches {counts}, expected "
                                 f"{want_counts}")
        if not path_ok:
            raise AssertionError(f"rope_attention {name} disagrees with its plain chain: {errs}")
        del q, k, v, w, cos, sin
        torch.cuda.empty_cache()
    record["rope"] = runs
    timing = {name: {key: r[key] for key in ("ms", "ms_min", "ms_max", "two_pass_ms", "plain_ms",
                                              "library_ms", "bound_ms", "bound_by")}
              for name, r in runs.items()}
    return timing, worst, path_counts


# The FLUX-shaped DiT at full width (benchmarks/dit_bench.py:33-42: dim
# 1536, 24 heads of 64, depth 4; 4608 tokens at 1024px), B1, bf16; the
# regression target x + DIT_NOISE·noise (the blocks learn to leave x
# nearly as it is: adaLN-zero's gates shrink), plain SGD with lr DIT_LR.
DIT_WIDTH = dict(dim=1536, num_heads=24, depth=4)
DIT_B, DIT_S = 1, 4608
DIT_NOISE, DIT_LR = 0.1, 0.5


def dit_recipe(recipe):
    """The DiT's quantization config of a recipe name (None: dense)."""
    from umfa_tpu_torch.engine.config import QuantizationConfig

    return {"bf16": None, "int8": QuantizationConfig(),
            "int4": QuantizationConfig.from_mode_string("int4")}[recipe]


def dit_data(cfg, b, s, dev, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    x, noise = (torch.randn((b, s, cfg.dim), generator=g) for _ in range(2))
    cond = torch.randn((b, cfg.dim), generator=g)
    return (x.to(dev, cfg.tdtype), cond.to(dev, cfg.tdtype),
            (x + DIT_NOISE * noise).to(dev, torch.float32))


def dit_loss(model, x, cond, tgt):
    from umfa_tpu_torch.models import dit

    return ((dit.forward(model, x, cond).float() - tgt) ** 2).mean()


@contextlib.contextmanager
def dit_attention_inputs(store):
    """Record the (q, k, v) each DiT block hands its attention call (after
    the interleaved RoPE), detached, in `store`."""
    from umfa_tpu_torch.models import dit

    attend = dit._attention

    def grab(q, k, v, cfg, *rest):
        store.append((q.detach(), k.detach(), v.detach()))
        return attend(q, k, v, cfg, *rest)

    dit._attention = grab
    try:
        yield
    finally:
        dit._attention = attend


def dit_block_check(model, x, cond, recipe, gen):
    """The first block's attention inputs at full width (B1 H24 S4608 D64,
    bf16, non-causal) through the recipe's attention call, held to its
    plain versions by `attention_call_check`."""
    import torch

    from umfa_tpu_torch.models import dit

    cfg = model.cfg
    store = []
    with torch.no_grad(), dit_attention_inputs(store):
        dit.block_forward(model.blocks[0], x, cond, cfg)
    return attention_call_check(f"dit_block/{recipe}", *store[0], cfg.quantization, cfg.causal,
                                gen)


def attention_call_check(name, q, k, v, quantization, causal, gen, bias=None):
    """One attention call (`flash_attention`, or `quantized_flash_attention`
    under `quantization`) with the LSE and `.backward()` of a seeded dO,
    against the same call with every wrapper's plain version
    (`plain_kernels()`): dense (rows 1-3) out relerr 1e-2, LSE abs 1e-3,
    gradients relerr 2e-2; int8 and int4 (rows 7-9) out 1e-3, LSE 1e-4,
    gradients 2e-2. The kernel call launches each of its three kernels
    once."""
    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.ops.attention import flash_attention
    from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention
    from umfa_tpu_torch.utils.testing import rel_err

    do = torch.randn(q.shape, generator=gen).to(q.device, q.dtype)

    def call():
        t = [a.clone().requires_grad_(True) for a in (q, k, v)]
        if quantization is None:
            out, lse = flash_attention(*t, bias, causal=causal, return_lse=True)
        else:
            out, lse = quantized_flash_attention(*t, bias, config=quantization, causal=causal,
                                                 return_lse=True)
        out.backward(do)
        return out.detach(), lse.detach(), *(a.grad for a in t)

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    got = call()
    torch.cuda.synchronize()
    counts = {key: n for key, n in _kernels.launches.items() if n}
    with plain_kernels():
        want = call()
    fgate, lgate = (1e-2, 1e-3) if quantization is None else (1e-3, 1e-4)
    res = compare(name, got[:2], want[:2], fgate, lgate)
    res.update(shape="B{} H{} S{} D{} {} {}".format(*q.shape, str(q.dtype).split(".")[1],
                                                    "causal" if causal else "non-causal"),
               launches=counts, tol_grads=2e-2,
               **{f"relerr_{n}": rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got[2:],
                                                                   want[2:])})
    want_counts = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                                if quantization is None
                                else ("fused_qattn", "quant_bwd_dq", "quant_bwd_dkv"), 1)
    res["ok"] = (res["ok"] and counts == want_counts
                 and all(res[f"relerr_{n}"] <= 2e-2 and torch_isfinite(g.float())
                         for n, g in zip(("dq", "dk", "dv"), got[2:])))
    emit({"phase": "kernel_check", **res})
    if not res["ok"]:
        raise AssertionError(f"{name}: the attention kernels disagree with their plain "
                             f"versions (or launched {counts}, expected {want_counts}): {res}")
    return res


def phase_dit(record):
    """The full-width DiT (DIT_WIDTH, B1 S4608, bf16) dense, under int8 and
    under int4: a timed forward (no grad) and a warm-up and three SGD steps
    whose loss falls, each with exact launches (dense: flash_fwd, and in a
    step flash_bwd_dq and flash_bwd_dkv, once a block; quantized: fused_qattn,
    and in a step quant_bwd_dq and quant_bwd_dkv); forward ms, step ms and
    peak memory. Between the forward and the steps, the first block's
    attention kernels on that block's own q, k, v against their plain
    versions (`dit_block_check`). Then a reduced DiT (full width, depth 1, S 512, fp32) through
    the kernels against the same model with every wrapper's plain version
    (`plain_kernels()`), on the card: dense loss abs 1e-5 and every gradient
    atol = rtol = 1e-4; int8 and int4 loss abs 1e-4 and every gradient
    relerr 1e-2 (the CPU parity tolerances of tests/test_torch_dit.py)."""
    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.models import dit
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    kernels_of = {"bf16": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                  "int8": ("fused_qattn", "quant_bwd_dq", "quant_bwd_dkv")}
    kernels_of["int4"] = kernels_of["int8"]
    every = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_dbias", "fused_qattn",
             "quant_bwd_dq", "quant_bwd_dkv", "quant_rows", "quant_attn_fwd")
    out, path_counts = {}, []
    for recipe in ("bf16", "int8", "int4"):
        cfg = dit.DiTConfig(**DIT_WIDTH, dtype="bfloat16", quantization=dit_recipe(recipe))
        model = dit.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
        x, cond, tgt = dit_data(cfg, DIT_B, DIT_S, dev, 31)
        fwd_k, dq_k, dkv_k = kernels_of[recipe]
        want_fwd = {key: cfg.depth if key == fwd_k else 0 for key in every}
        want_step = {key: cfg.depth if key in (fwd_k, dq_k, dkv_k) else 0 for key in every}
        with torch.no_grad():
            dit.forward(model, x, cond)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            y = dit.forward(model, x, cond)
            torch.cuda.synchronize()
            fwd = {"phase": "dit_forward", "recipe": recipe,
                   "fwd_ms": (time.perf_counter() - t0) * 1e3,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "finite": torch_isfinite(y), "shape_ok": tuple(y.shape) == tuple(x.shape),
                   "launches": dict(_kernels.launches)}
            del y
        emit(fwd)
        path_counts.append(fwd["launches"])
        if not (fwd["finite"] and fwd["shape_ok"]):
            raise AssertionError(f"DiT {recipe} forward: non-finite or misshaped output")
        if {key: fwd["launches"].get(key, 0) for key in every} != want_fwd:
            raise AssertionError(f"DiT {recipe} forward: launches {fwd['launches']}, "
                                 f"expected {want_fwd}")
        block_check = dit_block_check(model, x, cond, recipe, torch.Generator().manual_seed(41))
        torch.cuda.empty_cache()
        steps = []
        for i in range(4):  # one warm-up step, then three timed ones
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            loss = dit_loss(model, x, cond, tgt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            with torch.no_grad():
                for prm in model.parameters():
                    prm -= DIT_LR * prm.grad
                    prm.grad = None
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            counts = dict(_kernels.launches)
            step = {"phase": "dit_training", "recipe": recipe, "step": i, "warmup": i == 0,
                    "loss": loss.item(), "fwd_ms": (t1 - t0) * 1e3, "bwd_ms": (t2 - t1) * 1e3,
                    "sgd_ms": (t3 - t2) * 1e3, "step_ms": (t3 - t0) * 1e3,
                    "tokens_per_s": DIT_B * DIT_S / (t3 - t0),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts}
            del loss
            emit(step)
            steps.append(step)
            if i > 0:
                path_counts.append(counts)
            if not math.isfinite(step["loss"]) or (i > 0 and not step["loss"] < steps[i - 1]["loss"]):
                raise AssertionError(f"DiT {recipe} training step {i}: loss {step['loss']} is not "
                                     f"finite and below the step before's")
            if {key: counts.get(key, 0) for key in every} != want_step:
                raise AssertionError(f"DiT {recipe} training step {i}: launches {counts}, "
                                     f"expected {want_step}")
        out[recipe] = {"forward": fwd, "block_check": block_check, "steps": steps}
        del model, x, cond, tgt
        torch.cuda.empty_cache()

    # The reduced DiT through the kernels against the plain versions.
    small = {}
    for recipe in ("bf16", "int8", "int4"):
        cfg = dit.DiTConfig(**{**DIT_WIDTH, "depth": 1}, dtype="float32",
                            quantization=dit_recipe(recipe))
        x, cond, tgt = dit_data(cfg, 1, 512, dev, 37)
        res = {}
        for how in ("kernels", "plain"):
            model = dit.init_params(cfg, torch.Generator().manual_seed(1), device=dev)
            with plain_kernels() if how == "plain" else contextlib.nullcontext():
                loss = dit_loss(model, x, cond, tgt)
                loss.backward()
            res[how] = (loss.item(), {n: prm.grad for n, prm in model.named_parameters()})
            del model, loss
        (lk, gk), (lp, gp) = res["kernels"], res["plain"]
        if recipe == "bf16":
            grads_ok = all(torch.allclose(gk[n], gp[n], atol=1e-4, rtol=1e-4) for n in gp)
            loss_tol = 1e-5
        else:
            grads_ok = all(rel_err(gk[n], gp[n]) <= 1e-2 for n in gp)
            loss_tol = 1e-4
        r = {"phase": "dit_small_vs_plain", "recipe": recipe, "loss_kernels": lk,
             "loss_plain": lp, "loss_abs": abs(lk - lp), "tol_loss": loss_tol,
             "grads": len(gp), "worst_grad_relerr": max(rel_err(gk[n], gp[n]) for n in gp),
             "worst_grad_abs": max(float((gk[n] - gp[n]).abs().max()) for n in gp),
             "grads_ok": grads_ok}
        emit(r)
        small[recipe] = r
        del res, gk, gp
        if not (r["loss_abs"] <= loss_tol and grads_ok):
            raise AssertionError(f"the reduced DiT through the kernels differs from the plain "
                                 f"versions: {r}")
    torch.cuda.empty_cache()
    record["dit"] = {"config": DIT_WIDTH, "batch": DIT_B, "seq": DIT_S, "lr": DIT_LR,
                     "noise": DIT_NOISE, "runs": out, "small_vs_plain": small}
    return path_counts


# MLA at bench.py's geometry (_mla_setup :738-745, the demo's
# examples/deepseek_mla_demo.py:27-31): dim 1024, 16 heads of 64, latent
# 128, batch 8, ctx 4096 (the cache filled to 4032), decode in chunks of 8
# steps, bf16; the demo's indexer_topk 128 as a second forward. The
# DeepSeek demo model (examples/deepseek_mla_demo.py:56-60) at batch 8: the
# forward on 4096 tokens, generate from 1024 prompt tokens, 32 new ones,
# max_len 4096. The reduced fp32 DeepSeek is tests/test_models.py:143-147's.
MLA_WIDTH = dict(dim=1024, num_heads=16, latent_dim=128)
MLA_B, MLA_CTX, MLA_CHUNK, MLA_TOPK = 8, 4096, 8, 128
MLA_TPU_PARITY = 0.0034  # BENCH_r05.json mla_parity_relerr, measured on a TPU v5e
DS_WIDTH = dict(vocab=512, dim=512, num_heads=8, latent_dim=64, depth=2, num_experts=16,
                top_k=4, n_shared=1, moe_hidden=512)
DS_B, DS_S, DS_PROMPT, DS_NEW = 8, 4096, 1024, 32
# W4A16 against x @ W at K 1024: tests/test_gemm.py's 0.12 is a K 128 gate;
# a longer column has a larger absmax, so a coarser INT4 step, and the
# reference's own error here is ~0.143 (tests/test_torch_gemm.py
# `test_w4a16_error_at_the_card_shape_matches_jax`, which holds both to this).
W4A16_GATE = 0.15
DS_SMALL = dict(vocab=64, dim=128, num_heads=4, latent_dim=16, depth=2, num_experts=4, top_k=2,
                n_shared=1, moe_hidden=64)


@contextlib.contextmanager
def mla_attention_inputs(store):
    """Record the (q, k, v, bias) each MLA layer hands flash_attention,
    detached, in `store`."""
    from umfa_tpu_torch.models import mla_model

    attend = mla_model.flash_attention

    def grab(q, k, v, bias=None, **kw):
        store.append(tuple(None if t is None else t.detach().contiguous()
                           for t in (q, k, v, bias)))
        return attend(q, k, v, bias, **kw)

    mla_model.flash_attention = grab
    try:
        yield
    finally:
        mla_model.flash_attention = attend


@contextlib.contextmanager
def moe_routes(store):
    """Record (idx, probs) of every router call of models/moe.py in `store`."""
    from umfa_tpu_torch.models import moe

    route = moe.router_topk

    def grab(params, x, cfg):
        w, idx, probs = route(params, x, cfg)
        store.append((idx.cpu(), probs.detach().cpu()))
        return w, idx, probs

    moe.router_topk = grab
    try:
        yield
    finally:
        moe.router_topk = route


def held_positions(routes_a, routes_b, batch, k):
    """(B, S) positions before each sequence's first token routed otherwise
    in any layer (causal attention carries a changed token to the rows after
    it, not before); a token routed otherwise must have its k-th and
    (k+1)-th router probabilities within 4 fp32 ulps. Returns (held, the
    number of tokens routed otherwise)."""
    import numpy as np
    import torch

    first = torch.zeros((batch, routes_a[0][0].shape[0] // batch), dtype=torch.bool)
    n = 0
    for (ia, pa), (ib, _) in zip(routes_a, routes_b, strict=True):
        differ = (ia != ib).any(-1)
        if differ.any():
            srt = pa[differ].sort(dim=-1, descending=True).values.numpy()
            gap = srt[:, k - 1] - srt[:, k]
            if not (gap <= 4 * np.spacing(srt[:, k - 1])).all():
                raise AssertionError(f"routes differ beyond a near-tie: gaps {gap}")
        n += int(differ.sum())
        first |= differ.reshape(batch, -1)
    return first.long().cumsum(dim=1) == 0, n


def launches_of(fn):
    """fn()'s result and the kernel launches it made, counted from 0."""
    import torch

    from umfa_tpu_torch import _kernels

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {key: n for key, n in _kernels.launches.items() if n}


def mla_kernel_check(name, inputs):
    """The recorded flash_fwd call (q, k, v, bias; causal) through the kernel
    against its plain version, two batch rows at a time, at row 1's bf16
    gates (out relerr 1e-2, LSE abs 1e-3; a visible row past it must be
    within it of the float64 LSE of the plain version's own rounding points,
    `lse_check`, as every bf16 LSE gate of the walks: in a row that sees one
    or two kept keys the fp32 plain version can round a bf16(P) one ulp off);
    and the kernel timed alone on it (median, min, max of 5) beside its bound
    (4·D flop a visible pair; q, k, v, out, LSE and the bias once) and the
    memory-efficient SDPA forward on the same float mask (a yardstick
    only)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from umfa_tpu_torch.ops import flash_fwd as ff
    from umfa_tpu_torch.utils.testing import lse_check

    q, k, v, bias = inputs
    got = ff.flash_attention_forward(q, k, v, bias, causal=True)
    want = [ff.flash_attention_forward_plain(q[i:i + 2], k[i:i + 2], v[i:i + 2],
                                             None if bias is None else bias[i:i + 2],
                                             causal=True)
            for i in range(0, q.shape[0], 2)]
    want = tuple(torch.cat(parts) for parts in zip(*want))
    res = compare(name, got, want, 1e-2, 1e-3)
    causal = torch.ones((q.shape[2], k.shape[2]), dtype=torch.bool, device=q.device).tril()
    res.update(lse_check(got[1], want[1], q, k, bias, 1e-3, keep=causal))
    res["ok"] = (res["relerr_out"] <= 1e-2 and res["lse_ok"] and res["empty_rows_exact"]
                 and res["finite"])
    res["shape"] = "B{} H{} S{} D{} causal bf16".format(*q.shape) + (
        "" if bias is None else f", bias {tuple(bias.shape)} fp32")
    t = cuda_stats(lambda: ff.flash_attention_forward(q, k, v, bias, causal=True),
                   iters=5, warmup=1)
    b, h, sq, d = q.shape
    t["flops"] = 4 * d * b * h * visible_pairs(sq, k.shape[2], -1, 0)
    t["bytes"] = sum(x.numel() * x.element_size() for x in (q, k, v, got[0], got[1])) + (
        0 if bias is None else bias.numel() * bias.element_size())
    t["ops_ms"] = t["flops"] / H100_BF16_FLOPS * 1e3
    t["bytes_ms"] = t["bytes"] / H100_HBM_BYTES * 1e3
    bound(t)
    # SDPA takes a float mask or is_causal: the causal mask folded into the bias.
    mask = None if bias is None else bias.masked_fill(~causal, float("-inf")).to(q.dtype)

    def sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  is_causal=bias is None)

    t["library_ms"] = cuda_stats(sdpa, iters=5, warmup=1)["ms"]
    del mask
    res["kernel_ms"] = t
    emit({"phase": "kernel_check", **res})
    if not res["ok"]:
        raise AssertionError(f"flash_fwd on the MLA forward's inputs disagrees with its plain "
                             f"version: {res}")
    return res


def phase_mla(record):
    """MLA and the DeepSeek-style model on the card, bf16 at the widths above:
    (a) the MLA forward dense and with the indexer's top-128 bias, each with
    exactly one flash_fwd launch, timed (median, min, max of 5), its
    recorded flash_fwd call against the plain version; (b) bench.py's
    decode parity (:760-790, stage_acc_mla :936-952): 8 absorbed decode
    steps, the output fed back, against 8 steps of the dense route
    (decompressed K/V in a bf16 KVCache, decode_attention's gemv route), from
    the same state: final relerr <= 1e-2, no launch, each route's ms per step
    and cache bytes; (c) the DeepSeek demo model: the forward at B8 S4096
    (finite logits, aux >= depth·(1 - 1e-5), exactly `depth` flash_fwd
    launches, timed) and greedy generate (tokens in range, the same tokens
    twice, no launch, prefill ms and ms per decode step); (d) the reduced fp32
    DeepSeek through the kernel against the same model with every wrapper's
    plain version: routes compared first, logits abs 1e-5 before any token
    routed otherwise, decode logits against the forward's 5e-3; (e)
    quantized_matmul at x (4096, 1024) @ W (1024, 1024) against x @ W in
    fp32 at tests/test_gemm.py's gates (W8A16 0.01, W4A16 0.12, W8A8 0.02,
    centered INT4 on shifted columns below half the uncentered error), W8A8's
    integer sums equal to an int64 product."""
    import dataclasses as dc

    import torch

    from umfa_tpu_torch.engine.config import Precision
    from umfa_tpu_torch.models import deepseek, mla_model
    from umfa_tpu_torch.ops import gemm
    from umfa_tpu_torch.ops.mla import mla_decompress
    from umfa_tpu_torch.serving import kv_cache as kvc
    from umfa_tpu_torch.serving.decode import decode_attention
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(53)
    path_counts, worst, out = [], 0.0, {}

    # (a) The MLA forward, dense and with the indexer.
    cfg = mla_model.MLAConfig(**MLA_WIDTH, causal=True, dtype="bfloat16")
    model = mla_model.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    x = torch.randn((MLA_B, MLA_CTX, cfg.dim), generator=gen).to(dev, bf16)
    forwards = {}
    for label, topk in (("dense", None), ("indexer", MLA_TOPK)):
        c = dc.replace(cfg, indexer_topk=topk)
        store = []
        with torch.no_grad(), mla_attention_inputs(store):
            y, counts = launches_of(lambda: mla_model.forward(model, x, c))
        path_counts.append(counts)
        r = {"phase": "mla_forward", "case": label, "launches": counts,
             "finite": torch_isfinite(y), "shape_ok": tuple(y.shape) == tuple(x.shape)}
        del y
        with torch.no_grad():
            r.update(cuda_stats(lambda: mla_model.forward(model, x, c), iters=5, warmup=1))
        check = mla_kernel_check(f"mla/{label}", store[0])
        worst = max(worst, check["max_abs_out"])
        r["kernel_check"] = check
        emit(r)
        forwards[label] = r
        del store
        torch.cuda.empty_cache()
        if not (r["finite"] and r["shape_ok"]):
            raise AssertionError(f"MLA {label} forward: non-finite or misshaped output")
        if counts != {"flash_fwd": 1}:
            raise AssertionError(f"MLA {label} forward: launches {counts}, expected one flash_fwd")
    out["forward"] = forwards

    # (b) Absorbed against dense decode from identical state.
    heads, d, lat = cfg.num_heads, cfg.head_dim, cfg.latent_dim
    fill = MLA_CTX - 64
    with torch.no_grad():
        lat_fill = mla_model.compress_kv(model, x[:, :fill])
        x0 = torch.randn((MLA_B, 1, cfg.dim), generator=gen).to(dev, bf16)
        lcache = kvc.append_latent(kvc.init_latent_cache(MLA_B, MLA_CTX, lat, bf16, device=dev),
                                   lat_fill)
        dcache = kvc.append(kvc.init_cache(MLA_B, heads, MLA_CTX, d, bf16, device=dev),
                            *mla_decompress(lat_fill, model.w_k_up, model.w_v_up,
                                            num_heads=heads))
    del x, lat_fill
    state = {"absorbed": lcache, "dense": dcache}

    def fresh(route):
        c = state[route]
        return dc.replace(c, **{f.name: getattr(c, f.name).clone()
                                for f in dc.fields(c)})

    @torch.no_grad()
    def steps(route, cache, y):
        for _ in range(MLA_CHUNK):
            if route == "absorbed":
                y, cache = mla_model.decode_step(model, y, cache, cfg)
            else:
                k_new, v_new = mla_decompress(mla_model.compress_kv(model, y), model.w_k_up,
                                              model.w_v_up, num_heads=heads)
                kvc.append(cache, k_new, v_new)
                q = torch.matmul(y, model.wq).reshape(MLA_B, 1, heads, d).transpose(1, 2)
                att = decode_attention(q, cache).transpose(1, 2).reshape(MLA_B, 1, cfg.dim)
                y = y + torch.matmul(att.to(y.dtype), model.wo)
            y = y.to(bf16)
        return y

    finals, decode = {}, {}
    for route in ("absorbed", "dense"):
        cache = fresh(route)
        finals[route], counts = launches_of(lambda: steps(route, cache, x0))
        path_counts.append(counts)
        times = []
        for _ in range(4):  # one warm-up, three timed chunks, each from the same state
            cache = fresh(route)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            steps(route, cache, x0)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / MLA_CHUNK)
        c = state[route]
        decode[route] = {"launches": counts, "ms_per_step": statistics.median(times[1:]),
                         "ms_per_step_min": min(times[1:]), "ms_per_step_max": max(times[1:]),
                         "cache_bytes": sum(getattr(c, f.name).numel()
                                            * getattr(c, f.name).element_size()
                                            for f in dc.fields(c) if f.name != "length")}
        if counts:
            raise AssertionError(f"MLA {route} decode launched kernels: {counts}")
    parity = rel_err(finals["absorbed"], finals["dense"])
    r = {"phase": "mla_decode", "steps": MLA_CHUNK, "fill": fill, "relerr": parity,
         "tol": 1e-2, "tpu_v5e_relerr": MLA_TPU_PARITY, "finite": torch_isfinite(
             finals["absorbed"]), **decode,
         "cache_bytes_ratio": decode["dense"]["cache_bytes"] / decode["absorbed"]["cache_bytes"]}
    emit(r)
    out["decode"] = r
    del state, lcache, dcache, finals, model
    torch.cuda.empty_cache()
    if not (parity <= 1e-2 and r["finite"]):
        raise AssertionError(f"absorbed MLA decode against the dense route: relerr {parity}")

    # (c) The DeepSeek demo model.
    dcfg = deepseek.DeepSeekConfig(**DS_WIDTH, dtype="bfloat16")
    dmodel = deepseek.init_params(dcfg, torch.Generator().manual_seed(1), device=dev)
    tokens = torch.randint(0, dcfg.vocab, (DS_B, DS_S), generator=gen).to(dev)
    with torch.no_grad():
        (logits, aux), counts = launches_of(lambda: deepseek.forward(dmodel, tokens, dcfg))
        path_counts.append(counts)
        torch.cuda.reset_peak_memory_stats()
        fwd = {"phase": "deepseek_forward", "launches": counts, "aux": float(aux),
               "finite": torch_isfinite(logits),
               "shape_ok": tuple(logits.shape) == (DS_B, DS_S, dcfg.vocab),
               **cuda_stats(lambda: deepseek.forward(dmodel, tokens, dcfg), iters=5, warmup=1),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del logits
    fwd["tokens_per_s"] = DS_B * DS_S / fwd["ms"] * 1e3
    emit(fwd)
    if not (fwd["finite"] and fwd["shape_ok"] and fwd["aux"] >= dcfg.depth * (1 - 1e-5)):
        raise AssertionError(f"DeepSeek forward: {fwd}")
    if counts != {"flash_fwd": dcfg.depth}:
        raise AssertionError(f"DeepSeek forward: launches {counts}, expected {dcfg.depth} "
                             f"flash_fwd")
    prompt = tokens[:, :DS_PROMPT]
    gen_tokens, counts = launches_of(lambda: deepseek.generate(
        dmodel, prompt, dcfg, max_new_tokens=DS_NEW, max_len=DS_S))
    path_counts.append(counts)
    again = deepseek.generate(dmodel, prompt, dcfg, max_new_tokens=DS_NEW, max_len=DS_S)
    caches = deepseek.init_caches(dcfg, DS_B, DS_S, device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(DS_NEW + 1)]
    torch.cuda.synchronize()
    ev[0].record()
    lg, caches = deepseek.decode_step(dmodel, prompt, caches, dcfg)
    ev[1].record()
    for i in range(2, DS_NEW + 1):
        lg, caches = deepseek.decode_step(dmodel, torch.argmax(lg, -1)[:, None], caches, dcfg)
        ev[i].record()
    torch.cuda.synchronize()
    step_ms = [ev[i - 1].elapsed_time(ev[i]) for i in range(2, DS_NEW + 1)]
    g = {"phase": "deepseek_generate", "launches": counts, "shape": list(gen_tokens.shape),
         "in_range": bool(((gen_tokens >= 0) & (gen_tokens < dcfg.vocab)).all()),
         "same_twice": bool(torch.equal(gen_tokens, again)),
         "prefill_ms": ev[0].elapsed_time(ev[1]), "ms_per_step": statistics.median(step_ms),
         "ms_per_step_min": min(step_ms), "ms_per_step_max": max(step_ms),
         "tokens_per_s": DS_B / statistics.median(step_ms) * 1e3}
    emit(g)
    if not (g["in_range"] and g["same_twice"] and g["shape"] == [DS_B, DS_NEW]) or counts:
        raise AssertionError(f"DeepSeek generate: {g}")
    out["deepseek"] = {"forward": fwd, "generate": g}
    del dmodel, tokens, caches, prompt
    torch.cuda.empty_cache()

    # (d) The reduced fp32 DeepSeek through the kernel against its plain versions.
    scfg = deepseek.DeepSeekConfig(**DS_SMALL, dtype="float32")
    smodel = deepseek.init_params(scfg, torch.Generator().manual_seed(2), device=dev)
    stokens = torch.randint(0, scfg.vocab, (2, 24), generator=gen).to(dev)
    runs = {}
    for how in ("kernels", "plain"):
        routes = []
        with torch.no_grad(), moe_routes(routes), (
                plain_kernels() if how == "plain" else contextlib.nullcontext()):
            res, counts = launches_of(lambda: deepseek.forward(smodel, stokens, scfg))
        runs[how] = (res, routes, counts)
    (lk, ak), rk, ck = runs["kernels"]
    (lp, ap), rp, cp = runs["plain"]
    held, rerouted = held_positions(rp, rk, 2, scfg.top_k)
    held = held.to(dev)
    caches = deepseek.init_caches(scfg, 2, 24, device=dev)
    dec = [deepseek.decode_step(smodel, stokens[:, :16], caches, scfg)[0]]
    dec += [deepseek.decode_step(smodel, stokens[:, t:t + 1], caches, scfg)[0]
            for t in range(16, 24)]
    dec_err = max(float((a - lk[:, t]).abs().max()) for a, t in zip(dec, range(15, 24)))
    small = {"phase": "deepseek_small_vs_plain", "launches_kernels": ck, "launches_plain": cp,
             "rerouted_tokens": rerouted, "held_positions": int(held.sum()),
             "logits_abs": float((lk - lp)[held].abs().max()), "tol_logits": 1e-5,
             "aux_abs": abs(float(ak) - float(ap)), "decode_vs_forward_abs": dec_err,
             "tol_decode": 5e-3}
    emit(small)
    out["small_vs_plain"] = small
    if not (small["logits_abs"] <= 1e-5 and small["aux_abs"] <= 1e-5 and dec_err <= 5e-3
            and ck == {"flash_fwd": scfg.depth} and not cp and held[:, 0].all()):
        raise AssertionError(f"the reduced DeepSeek through the kernel differs from its plain "
                             f"versions: {small}")
    del smodel

    # (e) quantized_matmul: each mode against x @ W, and against the float64
    # product of its own quantized operands (its arithmetic: 1e-6).
    w = torch.randn((1024, 1024), generator=gen).to(dev)
    xq = torch.randn((4096, 1024), generator=gen).to(dev)
    want = xq @ w
    gemms = {}
    for mode, prec, act, gate in (("w8a16", Precision.INT8, None, 0.01),
                                  ("w4a16", Precision.INT4, None, W4A16_GATE),
                                  ("w8a8", Precision.INT8, Precision.INT8, 0.02)):
        qw = gemm.quantize_weight(w, prec)
        got = gemm.quantized_matmul(xq, qw, activation_precision=act)
        codes = gemm._codes(qw).double()
        if act is None:
            exact = (xq.to(bf16).double() @ codes) * qw.scales.double()
        else:
            x_codes, x_scale = gemm.quantize_activations(xq)
            exact = (x_codes.double() @ codes) * (x_scale * qw.scales).double()
        gemms[mode] = {"relerr": rel_err(got, want), "tol": gate,
                       "arith_relerr": rel_err(got, exact),
                       **cuda_stats(lambda: gemm.quantized_matmul(xq, qw,
                                                                  activation_precision=act),
                                    iters=5, warmup=1)}
        del got, codes, exact
    shifted = 0.1 * torch.randn((1024, 1024), generator=gen) + 3 * torch.randn((1, 1024),
                                                                                generator=gen)
    shifted = shifted.to(dev)
    want_s = xq @ shifted
    errs = [rel_err(gemm.quantized_matmul(xq, gemm.quantize_weight(shifted, Precision.INT4,
                                                                   center=center)), want_s)
            for center in (False, True)]
    gemms["int4_centering"] = {"relerr_plain": errs[0], "relerr_centered": errs[1]}
    x_codes, _ = gemm.quantize_activations(xq)
    codes = gemm.quantize_weight(w, Precision.INT8).values
    exact = torch.equal(gemm.int8_matmul(x_codes, codes).cpu().long(),
                        x_codes.cpu().long() @ codes.cpu().long())
    gemms["w8a8_sums_exact"] = exact
    gemms["library_ms_fp32"] = cuda_ms(lambda: xq @ w, iters=5, warmup=1)
    emit({"phase": "quantized_matmul", "shape": "x (4096, 1024) @ W (1024, 1024) fp32", **gemms})
    out["quantized_matmul"] = gemms
    if not (all(gemms[m]["relerr"] < gemms[m]["tol"] and gemms[m]["arith_relerr"] <= 1e-6
                for m in ("w8a16", "w4a16", "w8a8")) and errs[1] < errs[0] / 2 and exact):
        raise AssertionError(f"quantized_matmul on the card: {gemms}")
    torch.cuda.empty_cache()
    record["mla"] = out
    return path_counts, worst


MLA_TRAIN_LR = 1.0   # plain SGD on the bf16 MLA layer, loss mean(forward(x)²); see PERF.md
# Plain SGD on the bf16 DeepSeek demo model, loss cross-entropy plus aux: on
# the CPU at B1 S512 lr 0.03 raised the aux loss and 0.1 the sum, while
# 0.01 lowered both each step (the aux loss's f_e is not differentiable, so
# a large step that reroutes tokens can raise it).
DS_TRAIN_LR = 0.01


def train_attention_check(name, inputs, gen):
    """A model's first recorded attention call (q, k, v, bias; causal)
    through rows 1-3: `flash_attention` with the LSE and `.backward()` of a
    seeded dO, each kernel launched once, against the same call with every
    wrapper's plain version (`plain_kernels()`, two batch rows at a time):
    out relerr 1e-2, LSE abs 1e-3 (a row past it held to it against the
    float64 LSE of the plain version's rounding points, `lse_check`, as in
    `mla_kernel_check`), gradients relerr 2e-2. Then dQ and dK/dV
    timed on its inputs (median, min, max of 5) beside their bounds (6·D and
    8·D flop a causal pair; q, k, v, dO, LSE, δ, the bias and the gradients
    once) and torch's SDPA backward on the same inputs (memory-efficient with
    the bias and the causal mask folded into one float mask, flash without a
    bias; a yardstick only). Returns (the check, {kernel: timing})."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.ops import flash_bwd as fb
    from umfa_tpu_torch.ops.attention import flash_attention
    from umfa_tpu_torch.utils.testing import lse_check, rel_err

    q, k, v, bias = inputs
    do = torch.randn(q.shape, generator=gen).to(q.device, q.dtype)

    def call(rows):
        t = [a[rows].clone().requires_grad_(True) for a in (q, k, v)]
        out, lse = flash_attention(*t, None if bias is None else bias[rows], causal=True,
                                   return_lse=True)
        out.backward(do[rows])
        return out.detach(), lse.detach(), *(a.grad for a in t)

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    got = call(slice(None))
    torch.cuda.synchronize()
    counts = {key: n for key, n in _kernels.launches.items() if n}
    with plain_kernels():
        want = [call(slice(i, i + 2)) for i in range(0, q.shape[0], 2)]
    want = tuple(torch.cat(parts) for parts in zip(*want))
    res = compare(name, got[:2], want[:2], 1e-2, 1e-3)
    causal = torch.ones((q.shape[2], k.shape[2]), dtype=torch.bool, device=q.device).tril()
    res.update(lse_check(got[1], want[1], q, k, bias, 1e-3, keep=causal))
    res["ok"] = (res["relerr_out"] <= 1e-2 and res["lse_ok"] and res["empty_rows_exact"]
                 and res["finite"])
    grads = ("dq", "dk", "dv")
    res.update(shape="B{} H{} S{} D{} causal bf16".format(*q.shape) + (
        "" if bias is None else f", bias {tuple(bias.shape)} fp32"), launches=counts,
        tol_grads=2e-2, **{f"relerr_{n}": rel_err(a, b) for n, a, b in zip(grads, got[2:],
                                                                             want[2:])})
    want_counts = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    res["ok"] = (res["ok"] and counts == want_counts
                 and all(res[f"relerr_{n}"] <= 2e-2 and torch_isfinite(g.float())
                         for n, g in zip(grads, got[2:])))
    emit({"phase": "kernel_check", **res})
    if not res["ok"]:
        raise AssertionError(f"{name}: rows 1-3 disagree with their plain versions (or launched "
                             f"{counts}, expected {want_counts}): {res}")
    out, lse = got[:2]
    del got, want
    torch.cuda.empty_cache()

    b, h, s, d = q.shape
    p = fb._prepare(q, k, v, out, lse, do, bias, None, True, None, None)
    pairs = b * h * visible_pairs(s, k.shape[2], -1, 0)
    bias_bytes = 0 if bias is None else bias.numel() * bias.element_size()
    reads = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 4 * 2 * lse.numel() + bias_bytes
    if bias is None:
        mask, causal, backend = None, True, SDPBackend.FLASH_ATTENTION
    else:
        keep = torch.ones((s, k.shape[2]), dtype=torch.bool, device=q.device).tril()
        mask, causal = bias.masked_fill(~keep, float("-inf")).to(q.dtype), False
        backend = SDPBackend.EFFICIENT_ATTENTION
    qg, kg, vg = (a.detach().requires_grad_(True) for a in (q, k, v))
    with sdpa_kernel(backend):
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, is_causal=causal)
    library_ms = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True),
                         iters=5, warmup=1)
    del o, mask
    timing = {}
    for kname, fn, per_pair, written in (
            ("flash_bwd_dq", lambda: fb._launch_dq(p, torch.bfloat16), 6, 2 * q.numel()),
            ("flash_bwd_dkv", lambda: fb._launch_dkv(p, torch.bfloat16), 8, 2 * 2 * k.numel())):
        flops = d * per_pair * pairs
        t = dict(**cuda_stats(fn, iters=5, warmup=1), flops=flops, bytes=reads + written,
                 ops_ms=flops / H100_BF16_FLOPS * 1e3,
                 bytes_ms=(reads + written) / H100_HBM_BYTES * 1e3, library_ms=library_ms,
                 library=("memory-efficient SDPA backward with the float mask" if bias is not None
                          else "flash SDPA backward") + " (dQ, dK and dV in one call)",
                 shape=res["shape"])
        bound(t)
        timing[kname] = t
    emit({"phase": "train_attention_timing", "case": name, **timing})
    del p, qg, kg, vg
    torch.cuda.empty_cache()
    return res, timing


def phase_mla_training(record):
    """MLA and DeepSeek training on the card, bf16: (a) the MLA layer at
    bench.py's geometry (dim 1024, 16 heads of 64, latent 128, B8 S4096
    causal, the indexer's top-128 bias), loss mean(forward(x)²), lr
    MLA_TRAIN_LR; (b) the DeepSeek demo model at B8 S4096, loss the
    next-token cross-entropy plus aux, lr DS_TRAIN_LR. Each: a warm-up and
    three plain-SGD steps (`sgd_steps`) with exactly one flash_fwd, one
    flash_bwd_dq and one flash_bwd_dkv launch a layer and no flash_dbias
    (the indexer's mask is a constant; the MoE's backward is plain torch),
    and the first layer's recorded call through rows 1-3 against their plain
    versions (`train_attention_check`)."""
    import torch

    from umfa_tpu_torch.models import deepseek, mla_model

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(59)
    out, path_counts, timing = {}, [], {}

    cfg = mla_model.MLAConfig(**MLA_WIDTH, causal=True, dtype="bfloat16", indexer_topk=MLA_TOPK)
    model = mla_model.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    x = torch.randn((MLA_B, MLA_CTX, cfg.dim), generator=gen).to(dev, torch.bfloat16)
    want = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "flash_dbias": 0}
    steps, counts = sgd_steps("mla_training", model,
                              lambda: mla_model.forward(model, x, cfg).float().square().mean(),
                              want, MLA_TRAIN_LR, MLA_B * MLA_CTX)
    path_counts += counts
    store = []
    with torch.no_grad(), mla_attention_inputs(store):
        mla_model.forward(model, x, cfg)
    check, timing["mla"] = train_attention_check("mla_training/indexer", store[0], gen)
    out["mla"] = {"config": dataclasses.asdict(cfg), "batch": MLA_B, "seq": MLA_CTX,
                  "steps": steps, "check": check}
    del model, x, store
    torch.cuda.empty_cache()

    dcfg = deepseek.DeepSeekConfig(**DS_WIDTH, dtype="bfloat16")
    dmodel = deepseek.init_params(dcfg, torch.Generator().manual_seed(1), device=dev)
    tokens = torch.randint(0, dcfg.vocab, (DS_B, DS_S + 1), generator=gen).to(dev)

    def ds_loss():
        logits, aux = deepseek.forward(dmodel, tokens[:, :-1], dcfg)
        lp = torch.log_softmax(logits, dim=-1)
        return -lp.gather(-1, tokens[:, 1:, None]).mean() + aux

    want = {"flash_fwd": dcfg.depth, "flash_bwd_dq": dcfg.depth, "flash_bwd_dkv": dcfg.depth,
            "flash_dbias": 0}
    steps, counts = sgd_steps("deepseek_training", dmodel, ds_loss, want, DS_TRAIN_LR,
                              DS_B * DS_S)
    path_counts += counts
    store = []
    with torch.no_grad(), mla_attention_inputs(store):
        deepseek.forward(dmodel, tokens[:, :-1], dcfg)
    check, timing["deepseek"] = train_attention_check("deepseek_training/layer0", store[0], gen)
    out["deepseek"] = {"config": dataclasses.asdict(dcfg), "batch": DS_B, "seq": DS_S,
                       "steps": steps, "check": check}
    del dmodel, tokens, store
    torch.cuda.empty_cache()
    record["mla_training"] = out
    return path_counts, timing


SDPA_DEPTH = 2


def phase_sdpa_override(record):
    """The SDPA override (utils/interop.py) at the GPT's width: a plain-torch
    stack of SDPA_DEPTH attention layers (dim 1024, Hq 16 / Hkv 8 with
    enable_gqa, D 64, B8 S4096, causal, bf16; random projections from a
    seed) calling F.scaled_dot_product_attention under use_torch_sdpa(),
    forward and `.backward()`: exactly one flash_fwd, one flash_bwd_dq and
    one flash_bwd_dkv launch a layer, the `fused_autograd` route counted
    once a layer; its output bit for bit the same stack calling the port's
    attention() directly; within 1e-2 relerr of torch's own SDPA with the
    override removed (a yardstick only); each stack's forward timed. Then
    nn.MultiheadAttention (dim 1024, 16 heads, B8 S4096, non-causal) under
    the override, training mode and eval under no_grad: its launches
    reported (its fast path need not reach the Python function)."""
    import torch
    import torch.nn.functional as F

    import umfa_tpu_torch
    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.utils.interop import use_torch_sdpa
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(61)
    b, s, dim, bf16 = B_TRAIN, S_TRAIN, 1024, torch.bfloat16

    def param(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(dev, bf16).requires_grad_(True)

    layers = [(param((dim, HQ * D), dim**-0.5), param((dim, 2 * HKV * D), dim**-0.5),
               param((HQ * D, dim), (HQ * D)**-0.5)) for _ in range(SDPA_DEPTH)]
    x = torch.randn((b, s, dim), generator=gen).to(dev, bf16)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    def direct(q, k, v):
        return umfa_tpu_torch.attention(q, k, v, is_causal=True)

    def stack(attend):
        h = x
        for wq, wkv, wo in layers:
            q = (h @ wq).reshape(b, s, HQ, D).transpose(1, 2)
            k, v = (h @ wkv).reshape(b, s, 2, HKV, D).permute(2, 0, 3, 1, 4)
            h = h + attend(q, k, v).transpose(1, 2).reshape(b, s, HQ * D) @ wo
        return h

    def run(attend):
        umfa_tpu_torch.reset_dispatch_stats()
        y, counts = launches_of(lambda: stack(attend))
        _kernels.reset_launch_counts()
        y.float().square().mean().backward()
        torch.cuda.synchronize()
        g_counts = {key: n for key, n in _kernels.launches.items() if n}
        grads = [w.grad.clone() for lw in layers for w in lw]
        for lw in layers:
            for w in lw:
                w.grad = None
        return y.detach(), counts, g_counts, umfa_tpu_torch.get_dispatch_stats(), grads

    with use_torch_sdpa():
        y_o, c_o, g_o, stats_o, grads_o = run(sdpa)
    y_d, c_d, g_d, _, grads_d = run(direct)
    if getattr(F.scaled_dot_product_attention, "_umfa_override", False):
        raise AssertionError("the SDPA override outlived its scope")
    with torch.no_grad():
        y_n = stack(sdpa)
        ms = {"override_fwd_ms": None, "direct_fwd_ms": None, "torch_sdpa_fwd_ms": None}
        with use_torch_sdpa():
            ms["override_fwd_ms"] = cuda_ms(lambda: stack(sdpa), iters=5, warmup=1)
        ms["direct_fwd_ms"] = cuda_ms(lambda: stack(direct), iters=5, warmup=1)
        ms["torch_sdpa_fwd_ms"] = cuda_ms(lambda: stack(sdpa), iters=5, warmup=1)
    res = {"phase": "sdpa_override", "depth": SDPA_DEPTH,
           "shape": f"B{b} S{s} dim {dim} Hq{HQ} Hkv{HKV} D{D} causal bf16, enable_gqa",
           "launches_forward": c_o, "launches_backward": g_o, "dispatch_stats": stats_o,
           "bit_equal_to_attention": bool(torch.equal(y_o, y_d)),
           "grads_bit_equal": all(torch.equal(a, c) for a, c in zip(grads_o, grads_d)),
           "relerr_vs_torch_sdpa": rel_err(y_o, y_n), "tol_torch_sdpa": 1e-2,
           "finite": torch_isfinite(y_o.float()), **ms}
    del y_n, y_d, grads_o, grads_d
    torch.cuda.empty_cache()

    mha = torch.nn.MultiheadAttention(dim, HQ, batch_first=True, device=dev, dtype=bf16)
    with torch.no_grad():
        want_train = mha(x, x, x, need_weights=False)[0]
        mha.eval()
        want_eval = mha(x, x, x, need_weights=False)[0]
        mha.train()
    with use_torch_sdpa():
        y_t, c_train = launches_of(lambda: mha(x, x, x, need_weights=False)[0])
        mha.eval()
        with torch.no_grad():
            y_e, c_eval = launches_of(lambda: mha(x, x, x, need_weights=False)[0])
    res["multihead_attention"] = {
        "shape": f"B{b} S{s} dim {dim} 16 heads non-causal bf16",
        "launches_training_mode": c_train, "launches_eval_no_grad": c_eval,
        "relerr_training_mode_vs_torch": rel_err(y_t.detach(), want_train),
        "relerr_eval_vs_torch": rel_err(y_e, want_eval)}
    emit(res)
    record["sdpa_override"] = res
    want_fwd = {"flash_fwd": SDPA_DEPTH}
    want_bwd = {"flash_bwd_dq": SDPA_DEPTH, "flash_bwd_dkv": SDPA_DEPTH}
    if not (res["bit_equal_to_attention"] and res["relerr_vs_torch_sdpa"] <= 1e-2
            and res["finite"] and c_o == want_fwd and g_o == want_bwd and c_d == want_fwd
            and stats_o["fused_autograd"] == SDPA_DEPTH == stats_o["total"]):
        raise AssertionError(f"the SDPA override at full width: {res}")
    del mha, x, layers, y_o, y_t, y_e, want_train, want_eval
    torch.cuda.empty_cache()
    return [c_o, g_o, c_train, c_eval]


def phase_utilities(record):
    """The utilities on the card: (a) the full-width GPT's parameters (the
    serving model, bf16) through utils/checkpoint.save and restore, bit for
    bit, on the card; (b) utils/timing.time_op on row 1 at the prefill shape
    within 10 % of `cuda_stats`' median on the same call (the card spun
    while each timed call is enqueued); (c) an
    engine/profiling.trace of one MLA training step at bench.py's geometry
    (indexer top-128) whose Chrome trace names flash_fwd, flash_bwd_dq and
    flash_bwd_dkv (chiprun_out/mla_step_trace/trace.json); (d) the native
    runtime's version and a `timed()` latency read back; (e) an
    AttentionDescriptor at the prefill shape equal to attention(), bit for
    bit."""
    import tempfile

    import torch

    import umfa_tpu_torch
    from umfa_tpu_torch.engine import profiling
    from umfa_tpu_torch.engine.descriptor import (AttentionDescriptor, MultiHeadShape,
                                                  SparsityPattern)
    from umfa_tpu_torch.models import gpt, mla_model
    from umfa_tpu_torch.native import runtime
    from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward
    from umfa_tpu_torch.utils import checkpoint
    from umfa_tpu_torch.utils.timing import time_op

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(67)
    res, path_counts = {"phase": "utilities"}, []

    cfg = gpt.GPTConfig(vocab=32768, dim=1024, num_heads=HQ, num_kv_heads=HKV, depth=8,
                        max_seq=SK, dtype="bfloat16")
    state = gpt.init_params(cfg, torch.Generator().manual_seed(0), device=dev).state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gpt.pt")
        t0 = time.perf_counter()
        checkpoint.save(path, state)
        t1 = time.perf_counter()
        back = checkpoint.restore(path, state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        nbytes = os.path.getsize(path)
    res["checkpoint"] = {
        "tensors": len(state), "file_bytes": nbytes, "save_s": t1 - t0, "restore_s": t2 - t1,
        "bit_equal": sorted(back) == sorted(state) and all(
            torch.equal(back[n], t) and back[n].dtype == t.dtype and back[n].device == t.device
            for n, t in state.items())}
    del state, back
    torch.cuda.empty_cache()

    q = torch.randn((B_SERVE, HQ, PROMPT, D), generator=gen).to(dev, torch.bfloat16)
    k, v = (torch.randn((B_SERVE, HKV, SK, D), generator=gen).to(dev, torch.bfloat16)
            for _ in range(2))
    # The card spins while the host enqueues each timed call, so the events
    # time the device, as time_op's back-to-back loop does (without the spin
    # the median carries ~0.16 ms of the wrapper's host time: 1.959 against
    # 1.793 ms on "NVIDIA H100 80GB HBM3, 700.00 W").
    median = cuda_stats(lambda: flash_attention_forward(q, k, v, causal=True),
                        before=lambda: torch.cuda._sleep(1_000_000))["ms"]
    best = time_op(lambda a, b_, c: flash_attention_forward(a, b_, c, causal=True), q, k, v,
                   iters=16, reps=3) * 1e3
    res["time_op"] = {"shape": f"B{B_SERVE} Hq{HQ} Hkv{HKV} Sq{PROMPT} Sk{SK} D{D} causal bf16",
                      "time_op_ms": best, "cuda_stats_ms": median, "ratio": best / median,
                      "tol": 0.1}

    desc = AttentionDescriptor(shape=MultiHeadShape(B_SERVE, HQ, PROMPT, D), kv_seq_len=SK,
                               num_kv_heads=HKV, sparsity=SparsityPattern.CAUSAL)
    with torch.no_grad():
        got, c_desc = launches_of(lambda: desc(q, k, v))
        want, c_api = launches_of(lambda: umfa_tpu_torch.attention(q, k, v, is_causal=True))
    path_counts += [c_desc, c_api]
    res["descriptor"] = {"bit_equal": bool(torch.equal(got, want)), "launches": c_desc,
                         "hash_equal": hash(desc) == hash(dataclasses.replace(desc))}
    del got, want

    with profiling.timed():
        flash_attention_forward(q, k, v, causal=True)
        torch.cuda.synchronize()
    res["native"] = {"version": runtime.version(), "lib": runtime.lib_path().name,
                     "last_latency_ms": profiling.get_last_latency_ms(),
                     "mean_latency_ns": runtime.get_mean_latency_ns()}
    del q, k, v
    torch.cuda.empty_cache()

    mcfg = mla_model.MLAConfig(**MLA_WIDTH, causal=True, dtype="bfloat16", indexer_topk=MLA_TOPK)
    model = mla_model.init_params(mcfg, torch.Generator().manual_seed(0), device=dev)
    x = torch.randn((MLA_B, MLA_CTX, mcfg.dim), generator=gen).to(dev, torch.bfloat16)
    mla_model.forward(model, x, mcfg).float().square().mean().backward()  # warm-up
    model.zero_grad(set_to_none=True)
    log_dir = os.path.join(REPO, "chiprun_out", "mla_step_trace")
    with profiling.trace(log_dir):
        _, counts = launches_of(
            lambda: mla_model.forward(model, x, mcfg).float().square().mean().backward())
    path_counts.append(counts)
    with open(os.path.join(log_dir, "trace.json")) as f:
        text = f.read()
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    res["trace"] = {"file": "chiprun_out/mla_step_trace/trace.json", "bytes": len(text),
                    "launches": counts, "names": {n: f'"{n}"' in text for n in names},
                    "kernels": {n: n in text for n in ("fwd_tc_kernel", "dq_tc_kernel",
                                                       "dkv_tc_kernel")}}
    del model, x, text
    torch.cuda.empty_cache()
    emit(res)
    record["utilities"] = res
    if not (res["checkpoint"]["bit_equal"] and abs(res["time_op"]["ratio"] - 1) <= 0.1
            and res["descriptor"]["bit_equal"] and c_desc == {"flash_fwd": 1}
            and res["native"]["last_latency_ms"] and res["native"]["last_latency_ms"] > 0
            and all(res["trace"]["names"].values())
            and counts == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}):
        raise AssertionError(f"the utilities on the card: {res}")
    return path_counts


# The mesh on one card (phase 18): eight virtual ranks of one card, as
# LocalRing's ranks; the reference ran its multi-device layer on eight
# virtual CPU devices only (MULTICHIP_r05.json).
MESH_RANKS = 8
MESH_B, MESH_S = B_TRAIN, S_TRAIN  # the GPT's attention width: HQ, HKV, D
QRING_REF = 0.0115  # MULTICHIP_r05.json: the quantized ring's relerr on the virtual mesh
# The mesh DiT's forward against the single-device DiT, bf16 relerr: twice
# tests/test_torch_dit.py's bound on the reference's own sharded-vs-single
# spread (REF_BF16_SPREAD 2e-3; measured 1.05e-3 at dim 256, depth 2), the
# model here being twice as deep.
DIT_MESH_GATE = 4e-3
PIPE_STAGES, PIPE_MICRO, PIPE_B, PIPE_S = 4, 8, 8, 1024
MOE_WIDTH = dict(dim=512, hidden=512, num_experts=16, top_k=4, n_shared=1, dispatch="dense")
EXAMPLES = {"quickstart": [], "serving_demo": [], "torch_sdpa_replacement": [],
            "deepseek_mla_demo": [], "flux_attention_benchmark": ["--iters", "8"]}


# Phase 19: head dims above 256, rows 1-4's wide bodies (csrc/wide_tc.cuh;
# flash_dbias's own body), at utils/fwd_timing.py's WIDE_SHAPE (the FLUX VAE
# decoder's mid-block), WIDE_BIAS_SHAPE and WIDE_GQA.
WIDE_FWD_GATES = {"bfloat16": (1e-2, 1e-3), "float32": (2e-5, 1e-5)}
WIDE_BWD_GATES = {"bfloat16": 2e-2, "float32": 1e-4}


def wide_plan(kind, d, dtype):
    """The plan of the wide body `kind` ("fwd", "dq" or "dkv") at head dim d
    on `dtype` inputs, as csrc/wide_tc.cuh reports it (umfa_flash_wide_plan)."""
    import ctypes

    import torch

    from umfa_tpu_torch import _kernels

    fn = _kernels.function("flash_fwd", "umfa_flash_wide_plan",
                           (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
    out = (ctypes.c_int * 5)()
    fn(d, ("fwd", "dq", "dkv").index(kind), int(dtype == torch.bfloat16), ctypes.addressof(out))
    return dict(zip(("chunk", "chunks", "slice", "slices", "smem_bytes"), out))


def phase_wide_heads(record):
    """Rows 1-4 at head dims above 256, bf16 and fp32. (a) The VAE mid-block's
    call at full width (WIDE_SHAPE) through F.scaled_dot_product_attention
    under use_torch_sdpa() and no_grad: exactly two flash_fwd launches (the
    row-max pass, then the column slices) and nothing else, its output the
    kernel's bit for bit, out and LSE against the plain version (row 1's
    gates); (b) attention() forward and `.backward()` at the same shape:
    exactly 2 flash_fwd, 1 flash_bwd_dq and 1 flash_bwd_dkv launches, dQ, dK
    and dV against the plain backward (rows 2-3's gates); (c) attention()
    with bias_grad=True at WIDE_BIAS_SHAPE (also 1 flash_dbias), and causal
    GQA at D 300 and 1024 (WIDE_GQA; at D 1024 also the bias gradient of a
    (1, Hq, S, S) bias), each against its plain versions. At the VAE shape,
    the bias case and D 1024 each kernel timed (median, min, max of 10)
    beside its plain version, its bound and the memory-efficient SDPA (a
    yardstick only: its forward, its backward, and for dbias its backward
    with a bias gradient; null, with torch's reason, where it refuses)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import umfa_tpu_torch
    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.ops import flash_bwd as fb
    from umfa_tpu_torch.ops import flash_fwd as ff
    from umfa_tpu_torch.utils.fwd_timing import WIDE_BIAS_SHAPE, WIDE_GQA, WIDE_SHAPE
    from umfa_tpu_torch.utils.interop import use_torch_sdpa
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(29)
    rows = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_dbias")
    worst = {name: 0.0 for name in rows}
    timing = {name: {} for name in rows}
    runs, path_counts, failed = [], [], []

    def library(fn):
        """The memory-efficient SDPA's time, or None and torch's reason."""
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return cuda_ms(fn), "memory-efficient SDPA"
        except RuntimeError as e:
            return None, f"none: the memory-efficient SDPA refused ({e})"[:300]

    def case(name, b, hq, hkv, s, d, causal, dt, bias_shape=None, sdpa=False, timed=False):
        dtype = getattr(torch, dt)
        elem = torch.tensor([], dtype=dtype).element_size()
        q = torch.randn((b, hq, s, d), generator=gen).to(dev, dtype)
        k, v = (torch.randn((b, hkv, s, d), generator=gen).to(dev, dtype) for _ in range(2))
        do = torch.randn((b, hq, s, d), generator=gen).to(dev, dtype)
        bias = None if bias_shape is None else torch.randn(bias_shape, generator=gen).to(dev)
        res = {"phase": "wide_heads", "case": name, "shape": f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} "
               f"{'causal' if causal else 'non-causal'} {dt}" + (
                   f", a {tuple(bias_shape)} fp32 bias, bias_grad" if bias is not None else "")}
        ok = True
        if sdpa:  # (a) the decoder's call
            _kernels.reset_launch_counts()
            with use_torch_sdpa(), torch.no_grad():
                y = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            torch.cuda.synchronize()
            res["sdpa_launches"] = dict(_kernels.launches)
            path_counts.append(res["sdpa_launches"])
            ok &= res["sdpa_launches"] == {"flash_fwd": 2}
        got = ff.flash_attention_forward(q, k, v, bias, causal=causal)
        if sdpa:
            res["sdpa_bit_equal_to_kernel"] = bool(torch.equal(y, got[0]))
            ok &= res["sdpa_bit_equal_to_kernel"]
            del y
        res["forward_check"] = compare(f"wide/{name}", got, ff.flash_attention_forward_plain(
            q, k, v, bias, causal=causal), *WIDE_FWD_GATES[dt])
        ok &= res["forward_check"]["ok"]
        worst["flash_fwd"] = max(worst["flash_fwd"], res["forward_check"]["max_abs_out"])
        out, lse = got
        del got
        torch.cuda.empty_cache()

        # (b) attention() forward and backward.
        t = [x.detach().requires_grad_(True) for x in (q, k, v)]
        tb = None if bias is None else bias.detach().requires_grad_(True)
        _kernels.reset_launch_counts()
        o = umfa_tpu_torch.attention(*t, tb, is_causal=causal, bias_grad=bias is not None)
        o.backward(do)
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
        path_counts.append(counts)
        want_counts = {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
        if bias is not None:
            want_counts.update({"flash_dbias": 1, f"flash_dbias/{dt}": 1})
        res["path_launches"] = counts
        ok &= counts == want_counts
        p = fb._prepare(q, k, v, out, lse, do, bias, None, causal, None, None)
        want = fb._plain(p)
        grads = [x.grad for x in t]
        res["path_bit_equal_out"] = bool(torch.equal(o.detach(), out))
        res["grad_relerr"] = {n: rel_err(g.float(), w) for n, g, w in
                              zip(("dq", "dk", "dv"), grads, want)}
        for n, key in (("dq", "flash_bwd_dq"), ("dk", "flash_bwd_dkv"), ("dv", "flash_bwd_dkv")):
            g, w = grads[("dq", "dk", "dv").index(n)], want[("dq", "dk", "dv").index(n)]
            worst[key] = max(worst[key], float((g.float() - w).abs().max()))
        ok &= res["path_bit_equal_out"] and all(
            e <= WIDE_BWD_GATES[dt] for e in res["grad_relerr"].values())
        del o, want, grads
        if bias is not None:
            shape = tuple(bias.shape)
            want_db = fb._plain_dbias(p, shape)
            res["dbias_relerr"] = rel_err(tb.grad, want_db)
            worst["flash_dbias"] = max(worst["flash_dbias"],
                                       float((tb.grad - want_db).abs().max()))
            ok &= res["dbias_relerr"] <= WIDE_BWD_GATES[dt]
            del want_db
        del t, tb
        torch.cuda.empty_cache()

        if timed:
            pairs = b * hq * visible_pairs(s, s, -1, 0 if causal else -1)
            peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_TF32_FLOPS / 3
            gdt = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
            qkv = elem * (q.numel() + k.numel() + v.numel())
            kx = k.repeat_interleave(hq // hkv, 1) if hq != hkv else k
            vx = v.repeat_interleave(hq // hkv, 1) if hq != hkv else v
            plan = {kind: wide_plan(kind, d, dtype) for kind in ("fwd", "dq", "dkv")}
            lib_fwd, lib_fwd_what = library(lambda: F.scaled_dot_product_attention(
                q, kx, vx, is_causal=causal))
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, kx, vx))
            try:
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
                lib_bwd = cuda_ms(lambda: torch.autograd.grad(og, (qg, kg, vg), do,
                                                              retain_graph=True))
                lib_bwd_what = "memory-efficient SDPA backward (dQ, dK and dV in one call)"
                del og
            except RuntimeError as e:
                lib_bwd, lib_bwd_what = None, (f"none: the memory-efficient SDPA backward "
                                               f"refused ({e})")[:300]
            lib_db = (None, None)
            if bias is not None:  # the same backward with a bias gradient, as phase 5's
                mask = bias if not causal else torch.where(
                    torch.ones((s, s), dtype=torch.bool, device=dev).tril(), bias, -math.inf)
                mask = mask.to(dtype, copy=True).requires_grad_(True)
                try:
                    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                        og = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
                    lib_db = (cuda_ms(lambda: torch.autograd.grad(og, (mask,), do,
                                                                  retain_graph=True)),
                              f"memory-efficient SDPA backward with a {tuple(mask.shape)} {dt} "
                              "bias gradient" + (" (causal folded in)" if causal else "")
                              + "; also computes dQ, dK, dV")
                    del og
                except RuntimeError as e:
                    lib_db = (None, f"none: the memory-efficient SDPA refused the bias "
                                    f"gradient ({e})"[:300])
                del mask
            del qg, kg, vg, kx, vx
            torch.cuda.empty_cache()
            passes = {  # row: (kernel, plain, flops, bytes, launches, library)
                "flash_fwd": (lambda: ff.flash_attention_forward(q, k, v, bias, causal=causal),
                              lambda: ff.flash_attention_forward_plain(q, k, v, bias,
                                                                       causal=causal),
                              4 * d * pairs, qkv + elem * q.numel() + 4 * lse.numel(), 2,
                              (lib_fwd, lib_fwd_what)),
                "flash_bwd_dq": (lambda: fb._launch_dq(p, gdt), lambda: fb._plain_dq(p),
                                 6 * d * pairs, qkv + 2 * elem * q.numel() + 8 * lse.numel(), 1,
                                 (lib_bwd, lib_bwd_what)),
                "flash_bwd_dkv": (lambda: fb._launch_dkv(p, gdt), lambda: fb._plain_dkv(p),
                                  8 * d * pairs,
                                  qkv + elem * (q.numel() + k.numel() + v.numel())
                                  + 8 * lse.numel(), 1, (lib_bwd, lib_bwd_what)),
            }
            if bias is not None:
                shape = tuple(bias.shape)
                passes["flash_dbias"] = (
                    lambda: fb._launch_dbias(p, shape), lambda: fb._plain_dbias(p, shape),
                    4 * d * pairs, qkv + elem * q.numel() + 8 * bias.numel(), 1, lib_db)
            res["timing"] = {}
            for row, (kern, plain, flops, nbytes, n, (lib_ms, lib_what)) in passes.items():
                tm = dict(**cuda_stats(kern), plain_ms=cuda_ms(plain, iters=3, warmup=1),
                          library_ms=lib_ms, library=lib_what, launches=n, flops=flops,
                          bytes=nbytes, ops_ms=flops / peak * 1e3,
                          bytes_ms=nbytes / H100_HBM_BYTES * 1e3, shape=res["shape"])
                if row != "flash_dbias":
                    tm["plan"] = plan[{"flash_fwd": "fwd", "flash_bwd_dq": "dq"}.get(row, "dkv")]
                bound(tm)
                res["timing"][row] = tm
                timing[row][f"{dt}/{name}"] = tm
                torch.cuda.empty_cache()
        res["ok"] = bool(ok)
        emit(res)
        runs.append(res)
        if not ok:
            failed.append(name)
        del q, k, v, do, bias, out, lse, p
        torch.cuda.empty_cache()

    b, h, s, d = WIDE_SHAPE
    bb, bh, bs, bd = WIDE_BIAS_SHAPE
    dims, gb, ghq, ghkv, gs = WIDE_GQA
    for dt in ("bfloat16", "float32"):
        case("vae_mid_block", b, h, h, s, d, False, dt, sdpa=True, timed=True)
        case("bias_grad", bb, bh, bh, bs, bd, False, dt, bias_shape=(1, bh, bs, bs), timed=True)
        for gd in dims:
            case(f"causal_gqa_d{gd}", gb, ghq, ghkv, gs, gd, True, dt,
                 bias_shape=(1, ghq, gs, gs) if gd == max(dims) else None,
                 timed=gd == max(dims))
    record["wide_heads"] = runs
    if failed:
        raise AssertionError(f"wide heads: cases off their gates or launches: {failed}")
    return timing, worst, path_counts


def pipeline_backward_calls(stages, micro):
    """The stage calls whose backward autograd runs in pipeline_apply: every
    call of the first S + M - 2 ticks feeds the next tick's rotation, which
    the loss reaches (its unused outputs get zero cotangents), and of the
    last tick only the last stage's, which is banked; the other stages'
    last outputs feed only the final rotation, which nothing reads."""
    return stages * (stages + micro - 2) + 1


@contextlib.contextmanager
def ring_step_calls(store):
    """Record each (q, k, v, bias) that ring.py hands `flash_attention`,
    detached, in `store`."""
    from umfa_tpu_torch.parallel import ring

    attend = ring.flash_attention

    def grab(q, k, v, bias=None, **kw):
        store.append((q.detach(), k.detach(), v.detach(), bias))
        return attend(q, k, v, bias, **kw)

    ring.flash_attention = grab
    try:
        yield
    finally:
        ring.flash_attention = attend


def phase_mesh(record):
    """The mesh on one card: make_mesh over [cuda] * 8 virtual ranks.
    (a) sharded_attention at the GPT's attention width (B8 Hq16 Hkv8 S4096
    D64 bf16 causal): the heads/batch route on dp2/tp4, the sequence route
    on dp1/sp4/tp2 (contiguous and zigzag), the int8 heads route on tp8,
    each with exact launches (dp·tp of row 1, dp·tp·sp² on the ring, dp·tp
    of row 7), held to one unsharded call at row 1's gate (out relerr 1e-2;
    int8 1e-3) and timed beside it; (b) the quantized ring's accuracy cell
    (tests/test_parallel.py:257-304's data at that width, fp32, dp1/sp4/tp2)
    against float64 attention: under 0.03 and at most 1.5 × the single int8
    call's error + 5e-3, beside the reference's 1.15e-2; (c) the FLUX-shaped
    DiT (DIT_WIDTH, B1 S4608, bf16) on dp1/sp4/tp2: a timed forward held to
    the single-device DiT with the same weights at DIT_MESH_GATE, the first
    ring-step attention call held to its plain versions, a warm-up and three
    SGD steps (lr DIT_LR) whose loss falls, with exact launches; the int8
    DiT on tp8 the same way (rows 7-9); (d) pipeline_apply over four DiT
    blocks (pp 4, M 8, x B8 S1024, a fixed cond), forward and backward,
    against the sequential loop; (e) the MoE at the DeepSeek demo's width
    (dense dispatch), ep 8 against no ep_axis; (f) each of the five
    examples' main() on the card."""
    import dataclasses
    import io
    import types

    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.engine.config import QuantizationConfig
    from umfa_tpu_torch.models import dit, moe
    from umfa_tpu_torch.ops.attention import flash_attention
    from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention
    from umfa_tpu_torch.ops.quant_fused_attn import fused_path_supported
    from umfa_tpu_torch.parallel import make_mesh, pipeline_apply, sharded_attention
    from umfa_tpu_torch.utils.testing import rel_err

    dev = torch.device("cuda")
    ranks = [dev] * MESH_RANKS
    gen = torch.Generator().manual_seed(71)
    res, path_counts = {"phase": "mesh", "ranks": MESH_RANKS, "device": str(dev)}, []
    int8 = QuantizationConfig()

    def require_fused(cfg, sk, hq, hkv, causal):
        if not fused_path_supported(cfg, sk, D, causal=causal, window=None, seq_q=sk,
                                    num_heads=hq, num_kv_heads=hkv):
            raise AssertionError("phase 18 expects the single-launch quantized route")

    # (a) sharded_attention at the GPT's attention width.
    q = torch.randn((MESH_B, HQ, MESH_S, D), generator=gen).to(dev, torch.bfloat16)
    k, v = (torch.randn((MESH_B, HKV, MESH_S, D), generator=gen).to(dev, torch.bfloat16)
            for _ in range(2))
    with torch.no_grad():
        want, c_one = launches_of(lambda: flash_attention(q, k, v, causal=True))
        want_q, c_one_q = launches_of(
            lambda: quantized_flash_attention(q, k, v, config=int8, causal=True))
        one_ms = cuda_stats(lambda: flash_attention(q, k, v, causal=True), iters=5)
        one_q_ms = cuda_stats(lambda: quantized_flash_attention(q, k, v, config=int8,
                                                                causal=True), iters=5)
    routes = {"heads_dp2_tp4": (dict(dp=2, tp=4), {}),
              "ring_dp1_sp4_tp2": (dict(sp=4, tp=2), dict(seq_axis="sp")),
              "ring_zigzag_dp1_sp4_tp2": (dict(sp=4, tp=2), dict(seq_axis="sp", zigzag=True)),
              "int8_heads_tp8": (dict(tp=8), dict(quantization=int8))}
    res["sharded_attention"] = {"shape": f"B{MESH_B} Hq{HQ} Hkv{HKV} S{MESH_S} D{D} causal bf16",
                                "unsharded_ms": one_ms, "unsharded_int8_ms": one_q_ms,
                                "unsharded_launches": [c_one, c_one_q], "routes": {}}
    for name, (sizes, kw) in routes.items():
        mesh = make_mesh(**sizes, devices=ranks)
        dp, sp, tp = (mesh.shape[a] for a in ("dp", "sp", "tp"))
        attn = sharded_attention(mesh, causal=True, **kw)
        with torch.no_grad():
            out, counts = launches_of(lambda: attn(q, k, v))
            ms = cuda_stats(lambda: attn(q, k, v), iters=5)
        calls = dp * tp * (sp * sp if "seq_axis" in kw else 1)
        if "quantization" in kw:
            require_fused(int8, MESH_S, HQ // tp, HKV // tp, True)
            want_counts, ref, gate = {"fused_qattn": calls}, want_q, 1e-3
        else:
            want_counts, ref, gate = {"flash_fwd": calls}, want, 1e-2
        r = {"launches": counts, "expected": want_counts, "relerr_vs_unsharded": rel_err(out, ref),
             "tol": gate, "finite": torch_isfinite(out.float()), **ms}
        res["sharded_attention"]["routes"][name] = r
        path_counts.append(counts)
        if not (counts == want_counts and r["relerr_vs_unsharded"] <= gate and r["finite"]):
            raise AssertionError(f"sharded_attention {name}: {r}")
        del out
    del q, k, v, want, want_q
    torch.cuda.empty_cache()

    # (b) The quantized ring's accuracy cell (tests/test_parallel.py:257-304):
    # four channels of Q and K ×8, the scores scaled to a std of 0.5, fp32.
    qn = torch.randn((MESH_B, HQ, MESH_S, D), generator=gen, dtype=torch.float64)
    kn = torch.randn((MESH_B, HKV, MESH_S, D), generator=gen, dtype=torch.float64)
    ch = torch.randperm(D, generator=gen)[:4]
    qn[..., ch] *= 8.0
    kn[..., ch] *= 8.0
    qn, kn = qn.to(dev), kn.to(dev)
    s0 = qn[0] @ kn[0].repeat_interleave(HQ // HKV, dim=0).transpose(-1, -2) / math.sqrt(D)
    f = math.sqrt(0.5 / s0.std().item())
    del s0
    q, k = (qn * f).float(), (kn * f).float()
    v = torch.randn((MESH_B, HKV, MESH_S, D), generator=gen).to(dev)
    del qn, kn
    with torch.no_grad():
        exact = torch.cat([torch.softmax(
            (qb.double() @ kb.double().repeat_interleave(HQ // HKV, dim=1).transpose(-1, -2)
             / math.sqrt(D)).masked_fill(
                torch.ones(MESH_S, MESH_S, dtype=torch.bool, device=dev).triu(1), float("-inf")),
            dim=-1) @ vb.double().repeat_interleave(HQ // HKV, dim=1)
            for qb, kb, vb in zip(q.split(1), k.split(1), v.split(1))]).float()
        single = quantized_flash_attention(q, k, v, config=int8, causal=True)
        mesh = make_mesh(sp=4, tp=2, devices=ranks)
        ring = sharded_attention(mesh, seq_axis="sp", causal=True, quantization=int8)
        require_fused(dataclasses.replace(int8, smooth=False), MESH_S // 4, HQ // 2, HKV // 2,
                      False)
        got, counts = launches_of(lambda: ring(q, k, v))
    path_counts.append(counts)
    err_single, err_ring = rel_err(single, exact), rel_err(got, exact)
    cell = {"shape": f"B{MESH_B} Hq{HQ} Hkv{HKV} S{MESH_S} D{D} causal fp32, dp1/sp4/tp2",
            "err_ring": err_ring, "err_single": err_single, "reference_virtual_mesh": QRING_REF,
            "gate_abs": 0.03, "gate_rel": "1.5 x err_single + 5e-3", "launches": counts}
    res["quantized_ring_cell"] = cell
    if not (err_ring < 0.03 and err_ring <= 1.5 * err_single + 5e-3
            and counts == {"fused_qattn": 2 * 16}):
        raise AssertionError(f"the quantized ring's accuracy cell: {cell}")
    del q, k, v, exact, single, got
    torch.cuda.empty_cache()

    # (c) The FLUX-shaped DiT on the mesh.
    every = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_dbias", "fused_qattn",
             "quant_bwd_dq", "quant_bwd_dkv", "quant_rows", "quant_attn_fwd")
    res["dit"] = {}
    for recipe, sizes in (("bf16", dict(sp=4, tp=2)), ("int8", dict(tp=8))):
        mesh = make_mesh(**sizes, devices=ranks)
        sp, tp = mesh.shape["sp"], mesh.shape["tp"]
        cfg = dit.DiTConfig(**DIT_WIDTH, dtype="bfloat16", quantization=dit_recipe(recipe),
                            tp_axis="tp", sp_axis="sp" if sp > 1 else None)
        single = dit.init_params(dataclasses.replace(cfg, tp_axis=None, sp_axis=None),
                                 torch.Generator().manual_seed(0), device=dev)
        model = dit.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
        x, cond, tgt = dit_data(cfg, DIT_B, DIT_S, dev, 31)
        calls = cfg.depth * tp * sp * sp
        fwd_k, dq_k, dkv_k = (("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if recipe == "bf16"
                              else ("fused_qattn", "quant_bwd_dq", "quant_bwd_dkv"))
        if recipe != "bf16":
            require_fused(cfg.quantization, DIT_S, cfg.num_heads // tp, cfg.num_heads // tp,
                          False)
        want_fwd = {key: calls if key == fwd_k else 0 for key in every}
        want_step = {key: calls if key in (fwd_k, dq_k, dkv_k) else 0 for key in every}
        with torch.no_grad(), mesh:
            y_one = dit.forward(single, x, cond)
            dit.forward(model, x, cond)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            y, counts = launches_of(lambda: dit.forward(model, x, cond))
            fwd_ms = (time.perf_counter() - t0) * 1e3
        path_counts.append(counts)
        r = {"mesh": dict(mesh.shape), "fwd_ms": fwd_ms,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches_forward": counts,
             "relerr_vs_single_device": rel_err(y, y_one), "tol_vs_single_device": DIT_MESH_GATE,
             "finite": torch_isfinite(y.float())}
        del y, y_one, single
        if {key: counts.get(key, 0) for key in every} != want_fwd or not (
                r["relerr_vs_single_device"] <= DIT_MESH_GATE and r["finite"]):
            raise AssertionError(f"the mesh DiT {recipe} forward: {r}, expected {want_fwd}")
        if recipe == "bf16":
            store = []
            with torch.no_grad(), mesh, ring_step_calls(store):
                dit.block_forward(model.blocks[0], x, cond, cfg)
            r["ring_step_check"] = attention_call_check(
                "mesh_dit_ring_step/bf16", *store[0][:3], None, cfg.causal,
                torch.Generator().manual_seed(43), bias=store[0][3])
            del store
        torch.cuda.empty_cache()
        steps = []
        for i in range(4):  # one warm-up step, then three timed ones
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with mesh:
                loss = dit_loss(model, x, cond, tgt)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            with torch.no_grad():
                for prm in model.parameters():
                    prm -= DIT_LR * prm.grad
                    prm.grad = None
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            counts = dict(_kernels.launches)
            step = {"step": i, "warmup": i == 0, "loss": loss.item(), "fwd_ms": (t1 - t0) * 1e3,
                    "bwd_ms": (t2 - t1) * 1e3, "sgd_ms": (t3 - t2) * 1e3,
                    "step_ms": (t3 - t0) * 1e3,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts}
            del loss
            steps.append(step)
            if i > 0:
                path_counts.append(counts)
            if not math.isfinite(step["loss"]) or (i > 0 and not step["loss"] < steps[i - 1]["loss"]):
                raise AssertionError(f"the mesh DiT {recipe} step {i}: loss {step['loss']} is not "
                                     f"finite and below the step before's")
            if {key: counts.get(key, 0) for key in every} != want_step:
                raise AssertionError(f"the mesh DiT {recipe} step {i}: launches {counts}, "
                                     f"expected {want_step}")
        r["steps"] = steps
        one = record.get("dit", {}).get("runs", {}).get(recipe)
        if one is not None:  # phase 14b's single-device DiT, same width, for comparison
            r["single_device"] = {"fwd_ms": one["forward"]["fwd_ms"],
                                  "step_ms": [st["step_ms"] for st in one["steps"][1:]],
                                  "peak_mem_gb": max(st["peak_mem_gb"] for st in one["steps"])}
        res["dit"][recipe] = r
        emit({"phase": "mesh_dit", "recipe": recipe, **{k_: v_ for k_, v_ in r.items()
                                                        if k_ != "ring_step_check"}})
        del model, x, cond, tgt
        torch.cuda.empty_cache()

    # (d) pipeline_apply over four DiT blocks.
    cfg = dit.DiTConfig(**{**DIT_WIDTH, "depth": PIPE_STAGES}, dtype="bfloat16")
    blocks = dit.init_params(cfg, torch.Generator().manual_seed(2), device=dev).blocks
    stacked = {n: torch.stack([getattr(b, n).detach() for b in blocks]).requires_grad_(True)
               for n in dit.PARAMS}
    del blocks
    x = torch.randn((PIPE_B, PIPE_S, cfg.dim), generator=gen).to(dev, torch.bfloat16)
    cond = torch.randn((1, cfg.dim), generator=gen).to(dev, torch.bfloat16)
    w = torch.randn(x.shape, generator=gen).to(dev)

    def stage(p, h):
        return dit.block_forward(types.SimpleNamespace(**p), h, cond, cfg)

    def run(fn):
        y, c_fwd = launches_of(fn)
        _, c_bwd = launches_of(lambda: (y.float() * w).sum().backward())
        grads = {n: p.grad for n, p in stacked.items()}
        for p in stacked.values():
            p.grad = None
        return y.detach(), c_fwd, c_bwd, grads

    mesh = make_mesh(PIPE_STAGES, devices=ranks, axis_names=("pp", "sp", "tp"))
    t0 = time.perf_counter()
    y, c_fwd, c_bwd, grads = run(lambda: pipeline_apply(stage, stacked, x, mesh=mesh,
                                                        num_microbatches=PIPE_MICRO))
    pipe_s = time.perf_counter() - t0

    def sequential():
        h = x
        for i in range(PIPE_STAGES):
            h = stage({n: p[i] for n, p in stacked.items()}, h)
        return h

    y_seq, s_fwd, s_bwd, g_seq = run(sequential)
    path_counts += [c_fwd, c_bwd]
    ticks = PIPE_STAGES + PIPE_MICRO - 1
    want_fwd = {"flash_fwd": PIPE_STAGES * ticks}
    n_bwd = pipeline_backward_calls(PIPE_STAGES, PIPE_MICRO)
    want_bwd = {"flash_bwd_dq": n_bwd, "flash_bwd_dkv": n_bwd}
    r = {"shape": f"pp{PIPE_STAGES} M{PIPE_MICRO} x B{PIPE_B} S{PIPE_S} dim {cfg.dim} bf16",
         "seconds": pipe_s, "launches_forward": c_fwd, "launches_backward": c_bwd,
         "expected_forward": want_fwd, "expected_backward": want_bwd,
         "sequential_launches": [s_fwd, s_bwd], "relerr_vs_sequential": rel_err(y, y_seq),
         "grad_relerr_vs_sequential": {n: rel_err(grads[n], g_seq[n]) for n in grads},
         "tol": 1e-2, "tol_grads": 2e-2}
    res["pipeline"] = r
    emit({"phase": "mesh_pipeline", **r})
    if not (c_fwd == want_fwd and c_bwd == want_bwd and r["relerr_vs_sequential"] <= 1e-2
            and all(e <= 2e-2 for e in r["grad_relerr_vs_sequential"].values())):
        raise AssertionError(f"pipeline_apply over four DiT blocks: {r}")
    del stacked, x, y, y_seq, grads, g_seq, w
    torch.cuda.empty_cache()

    # (e) The MoE at the DeepSeek demo's width, the experts over ep 8.
    mcfg = moe.MoEConfig(**MOE_WIDTH, dtype="bfloat16", ep_axis="ep")
    layer = moe.init_params(mcfg, torch.Generator().manual_seed(3), device=dev)
    xm = torch.randn((B_TRAIN, S_TRAIN, mcfg.dim), generator=gen).to(dev, torch.bfloat16)
    plain_cfg = dataclasses.replace(mcfg, ep_axis=None)
    with torch.no_grad():
        (y0, aux0), c0 = launches_of(lambda: moe.moe_ffn(layer, xm, plain_cfg))
        with make_mesh(MESH_RANKS, devices=ranks, axis_names=("ep", "sp", "tp")):
            (y1, aux1), c1 = launches_of(lambda: moe.moe_ffn(layer, xm, mcfg))
            ep_ms = cuda_stats(lambda: moe.moe_ffn(layer, xm, mcfg), iters=3)
        one_ms = cuda_stats(lambda: moe.moe_ffn(layer, xm, plain_cfg), iters=3)
    path_counts += [c0, c1]
    r = {"shape": f"B{B_TRAIN} S{S_TRAIN}", "config": MOE_WIDTH, "ep": MESH_RANKS,
         "relerr_vs_no_ep": rel_err(y1, y0), "max_abs": float((y1.float() - y0.float()).abs().max()),
         "aux_equal": bool(torch.equal(aux0, aux1)), "launches": c1, "ep_ms": ep_ms,
         "no_ep_ms": one_ms, "tol": 1e-2}
    res["moe_ep"] = r
    if not (r["relerr_vs_no_ep"] <= 1e-2 and r["aux_equal"] and c1 == {} == c0):
        raise AssertionError(f"the MoE's ep route: {r}")
    del layer, xm, y0, y1
    torch.cuda.empty_cache()

    # (f) The examples on the card.
    import importlib

    res["examples"] = {}
    for name, argv in EXAMPLES.items():
        mod = importlib.import_module(f"umfa_tpu_torch.examples.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            _, counts = launches_of(lambda: mod.main(argv))
        path_counts.append(counts)
        text = buf.getvalue()
        ex = {"seconds": time.perf_counter() - t0, "launches": counts,
              "stdout_tail": text.splitlines()[-8:]}
        if name == "torch_sdpa_replacement":
            ex["relerr"] = [float(line.split("relerr ")[1]) for line in text.splitlines()
                            if "relerr" in line]
            if len(ex["relerr"]) != 3 or max(ex["relerr"]) > 1e-3:
                raise AssertionError(f"the SDPA replacement example on the card: {ex}")
        res["examples"][name] = ex
        if not counts:
            raise AssertionError(f"the example {name} launched no kernel on the card: {ex}")
    emit({"phase": "mesh", **{k_: v_ for k_, v_ in res.items() if k_ != "dit"}})
    record["mesh"] = res
    return path_counts


# The tensor-core kernels: library -> the stems of their function names.
TC_KERNELS = {"flash_fwd": ("fwd_tc_kernel", "fwd_wide_kernel"),
              "flash_bwd": ("dq_tc_kernel", "dkv_tc_kernel", "dq_wide_kernel", "dkv_wide_kernel"),
              "flash_dbias": ("dbias_tc_kernel",), "quant_bwd": ("dq_tc_kernel", "dkv_tc_kernel"),
              "quant_attn_fwd": ("quant_attn_fwd_tc_kernel",),
              "fused_qattn": ("fused_qattn_tc_kernel",),
              "ring_attn": ("fwd_tc_kernel", "dq_tc_kernel", "dkv_tc_kernel"),
              "flash_decode": ("flash_decode_tc_kernel",),
              "mma_probe": ("mma_probe_wg_kernel",)}
# The tensor-core instructions (SASS mnemonics) each library's kernels must
# hold: HMMA for bf16 (and tf32) mma.sync, IMMA for int8, DMMA for f64,
# HGMMA for the warpgroup products (wgmma).
TC_OPS = {"quant_attn_fwd": ("HMMA", "IMMA"), "fused_qattn": ("DMMA", "HMMA"),
          "mma_probe": ("HGMMA",)}
# pv_int8's instantiations (the last template argument PV = true, mangled),
# whose P·V is integer: IMMA in place of HMMA; how many each library holds.
PV_MANGLED = "Lb1EEEv"
PV_OPS = {"quant_attn_fwd": ("IMMA",), "fused_qattn": ("DMMA", "IMMA")}
PV_COUNT = {"quant_attn_fwd": 12, "fused_qattn": 24}
# Kernels on the CUDA cores whose registers and spills are listed beside
# the tensor-core ones: library -> the stems of their function names.
LISTED_KERNELS = {"quant_rows": ("quant_rows_vec_kernel",),
                  "mma_probe": ("mma_probe_merge_kernel",),
                  "fused_qattn": ("fused_rows_kernel", "fused_group_quant_kernel")}
# The fp32 dense forward and backward, the fp32 dbias and the fp32 ring
# steps: their 3xTF32 instantiations (product policy Tf32x3Mma) of every
# stem must hold TF32 HMMA (at D 64, 128 and 256 alike where the head dim
# is a template argument; the dbias body walks any depth in chunks), and the
# CUDA-core kernels they replaced must be gone.
TF32_POLICY, TF32_HMMA = "Tf32x3Mma", "HMMA.1688.F32.TF32"
TF32_LIBS = ("flash_fwd", "flash_bwd", "flash_dbias", "ring_attn")
TF32_WIDTH_LIBS = ("flash_fwd", "flash_bwd", "ring_attn")
TF32_WIDTHS = ("Li64E", "Li128E", "Li256E")  # the head-dim template argument, mangled
# The wide bodies (head_dim > 256), one instantiation a policy (the forward
# two: its row-max and column-slice passes), no head-dim argument.
WIDE_STEMS = ("fwd_wide_kernel", "dq_wide_kernel", "dkv_wide_kernel")
SIMT_GONE = {"flash_fwd": ("flash_fwd_kernel",),
             "flash_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
             "flash_dbias": ("flash_dbias_kernel",),
             "ring_attn": ("ring_fwd_step_kernel", "ring_bwd_dq_kernel", "ring_bwd_dkv_kernel"),
             "flash_decode": ("flash_decode_kernel", "flash_decode_merge_kernel"),
             "mma_probe": ("mma_probe_kernel",)}
# Kernels that must exist and spill nothing: (library, stem, a substring of
# the mangled name) -> what it is. fused_qattn's D 256 instantiations
# (its bf16-Q-tile layout; <.., 256, SPARSE, PV>), the fp32 dbias, and the
# bf16 instantiations of flash_decode (template <DP, RT, BF16 = true>:
# "Lb1E"). The SPARSE pv_int8 ones at D 256 are held to SPILL_CAP instead.
# fwd_tc_kernel's ROPE instantiations (RING, SPARSE, ROPE = false, false,
# true), mangled.
ROPE_MANGLED = "Lb0ELb0ELb1EE"
NO_SPILL = {("fused_qattn", "fused_qattn_tc_kernel", "Li256ELb0ELb0E"): "fused_qattn D 256",
            ("fused_qattn", "fused_qattn_tc_kernel", "Li256ELb1ELb0E"): "fused_qattn D 256 SPARSE",
            ("fused_qattn", "fused_qattn_tc_kernel", "Li256ELb0ELb1E"): "fused_qattn D 256 pv_int8",
            ("flash_dbias", "dbias_tc_kernel", TF32_POLICY): "fp32 flash_dbias",
            ("flash_decode", "flash_decode_tc_kernel", "Lb1E"): "bf16 flash_decode",
            ("flash_fwd", "fwd_wide_kernel", ""): "wide flash_fwd (D > 256)",
            ("flash_bwd", "dq_wide_kernel", ""): "wide flash_bwd_dq (D > 256)",
            ("flash_bwd", "dkv_wide_kernel", ""): "wide flash_bwd_dkv (D > 256)"}


# Kernels held to a spill ceiling in bytes (stores and loads): fused_qattn's
# SPARSE pv_int8 instantiations at D 256 spilled 64 (32 + 32) beside the walk's
# state; a simple kernel first (PERF.md §6).
SPILL_CAP = {("fused_qattn", "fused_qattn_tc_kernel", "Li256ELb1ELb1E"):
             ("fused_qattn D 256 SPARSE pv_int8", 128)}


def ptxas_resources(log):
    """{entry function: registers, spill stores and loads} from ptxas -v."""
    import re

    res, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
            res[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if fn and m:
            res[fn]["spill_stores"], res[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if fn and m:
            res[fn]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if fn and m:
            res[fn]["static_smem_bytes"] = int(m.group(1))
    return res


def phase_sass(record, report):
    """Count the HMMA (or, per TC_OPS, IMMA, DMMA and HGMMA) tensor-core
    instructions of each tensor-core kernel in its library's SASS (cuobjdump
    -sass); raise if a kernel has none of one of them, if an fp32 (3xTF32)
    instantiation of the dense forward or backward or of a ring kernel has
    no TF32 HMMA (or one of the D 64, 128 and 256 instantiations of a stem
    is missing), if a CUDA-core kernel that a tensor-core one replaced is
    left, or if ptxas reports that it serialized the probe's wgmma
    pipeline. With each kernel (and the CUDA-core kernels of
    LISTED_KERNELS) its registers and spills (ptxas -v, when this run built
    the library) and the dynamic shared memory it launches with."""
    import ctypes
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from umfa_tpu_torch import _kernels

    kernels, smem = {}, {}
    for lib, stems in TC_KERNELS.items():
        sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                               str(_kernels._lib_path(lib))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        ops = TC_OPS.get(lib, ("HMMA",))
        fn = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                left = [k for k in SIMT_GONE.get(lib, ()) if k in m.group(1)]
                if left:
                    raise AssertionError(f"{lib} still holds the CUDA-core {left[0]}")
                stem = next((st for st in stems if st in m.group(1)), None)
                fn = f"{lib}:{m.group(1)}" if stem else None
                fops = PV_OPS[lib] if lib in PV_OPS and PV_MANGLED in m.group(1) else ops
                if fn:
                    kernels[fn] = {"library": lib, "stem": stem, **{op.lower(): 0 for op in fops}}
                    if TF32_POLICY in fn:
                        kernels[fn]["hmma_tf32"] = 0
            elif fn:
                for op in fops:
                    if op in ln:
                        kernels[fn][op.lower()] += 1
                if TF32_HMMA in ln and "hmma_tf32" in kernels[fn]:
                    kernels[fn]["hmma_tf32"] += 1
        for stem in stems:
            found = [f for f in kernels if kernels[f]["library"] == lib and kernels[f]["stem"] == stem]
            for op in set(ops) | set(PV_OPS.get(lib, ())):
                have = [f for f in found if op.lower() in kernels[f]]
                if not have or any(kernels[f][op.lower()] == 0 for f in have):
                    raise AssertionError(f"no {op} in the SASS of {lib}'s {stem}: "
                                         f"{ {f: kernels[f][op.lower()] for f in have} }")
        if lib in PV_COUNT:
            pv = [f for f in kernels if kernels[f]["library"] == lib and PV_MANGLED in f]
            if len(pv) != PV_COUNT[lib]:
                raise AssertionError(f"{lib} holds {len(pv)} pv_int8 instantiations, not "
                                     f"{PV_COUNT[lib]}: {pv}")
        if lib in TF32_LIBS:
            for stem in stems:
                found = [f for f in kernels if kernels[f]["library"] == lib
                         and kernels[f]["stem"] == stem and "hmma_tf32" in kernels[f]]
                if not found or any(kernels[f]["hmma_tf32"] == 0 for f in found):
                    raise AssertionError(f"no {TF32_HMMA} in the fp32 {stem} of {lib}: "
                                         f"{ {f: kernels[f].get('hmma_tf32') for f in found} }")
                widths = [w for w in TF32_WIDTHS if not any(w in f for f in found)]
                if widths and lib in TF32_WIDTH_LIBS and stem not in WIDE_STEMS:
                    raise AssertionError(f"the fp32 {stem} of {lib} lacks the instantiations "
                                         f"{widths}: {found}")
        if lib in report:
            for f, r in ptxas_resources(report[lib]["ptxas"]).items():
                if f"{lib}:{f}" in kernels:
                    kernels[f"{lib}:{f}"].update(r)
    for lib, stems in LISTED_KERNELS.items():
        if lib in report:
            for f, r in ptxas_resources(report[lib]["ptxas"]).items():
                stem = next((st for st in stems if st in f), None)
                if stem:
                    kernels[f"{lib}:{f}"] = {"library": lib, "stem": stem, **r}
    rope = [f for f, r in kernels.items() if r["library"] == "flash_fwd" and ROPE_MANGLED in f]
    if len(rope) != 12:  # bf16 and fp32 inputs, D 64/128/256, fp32 and bf16 out
        raise AssertionError(f"flash_fwd holds {len(rope)} ROPE instantiations, not 12: {rope}")
    serialized = [ln.strip() for ln in report.get("mma_probe", {}).get("ptxas", "").splitlines()
                  if re.search(r"wgmma.*serialized", ln)]
    if serialized:
        raise AssertionError(f"ptxas serialized the probe's wgmma pipeline: {serialized[:2]}")
    for (lib, stem, part), what in NO_SPILL.items():
        found = [f for f, r in kernels.items() if r["library"] == lib and r["stem"] == stem
                 and part in f]
        if not found:
            raise AssertionError(f"no {what} kernel in {lib}'s SASS")
        spilled = {f: kernels[f].get("spill_stores", 0) + kernels[f].get("spill_loads", 0)
                   for f in found}
        if any(spilled.values()):
            raise AssertionError(f"the {what} kernels spill: {spilled}")
    for (lib, stem, part), (what, cap) in SPILL_CAP.items():
        found = [f for f, r in kernels.items() if r["library"] == lib and r["stem"] == stem
                 and part in f]
        spilled = {f: kernels[f].get("spill_stores", 0) + kernels[f].get("spill_loads", 0)
                    for f in found}
        if not found or any(v > cap for v in spilled.values()):
            raise AssertionError(f"the {what} kernels spill more than {cap} bytes: {spilled}")
    fwd = _kernels.function("flash_fwd", "umfa_flash_fwd_smem_bytes", (ctypes.c_int, ctypes.c_int))
    fbwd = _kernels.function("flash_bwd", "umfa_flash_bwd_smem_bytes",
                             (ctypes.c_int, ctypes.c_int, ctypes.c_int))
    fdb = _kernels.function("flash_dbias", "umfa_flash_dbias_smem_bytes", (ctypes.c_int, ctypes.c_int))
    qbwd = _kernels.function("quant_bwd", "umfa_quant_bwd_smem_bytes", (ctypes.c_int, ctypes.c_int))
    qfwd = _kernels.function("quant_attn_fwd", "umfa_quant_attn_fwd_smem_bytes", (ctypes.c_int,))
    fq = _kernels.function("fused_qattn", "umfa_fused_qattn_smem_bytes", (ctypes.c_int,))
    rbwd = _kernels.function("ring_attn", "umfa_ring_bwd_smem_bytes",
                             (ctypes.c_int, ctypes.c_int, ctypes.c_int))
    rfwd = _kernels.function("ring_attn", "umfa_ring_fwd_smem_bytes", (ctypes.c_int, ctypes.c_int))
    fdec = _kernels.function("flash_decode", "umfa_flash_decode_smem_bytes", (ctypes.c_int,) * 4)
    probe = _kernels.function("mma_probe", "umfa_mma_probe_smem_bytes", (ctypes.c_int,) * 2)
    from umfa_tpu_torch.utils import mma_probe as mp

    for name, (m, k, n) in mp.SHAPES.items():
        tn, split = mp.plan(m, k, n)
        smem[f"mma_probe {name} 64x{tn} slice K {k // split}"] = probe(tn, k // split // 16)
    smem["quant_rows (static only)"] = 0
    for d in (64, 128, 256):
        smem[f"flash_fwd bf16 D{d}"] = fwd(d, 1)
        smem[f"flash_fwd fp32 D{d}"] = fwd(d, 0)
        smem[f"flash_bwd_dq bf16 D{d}"] = fbwd(d, 0, 1)
        smem[f"flash_bwd_dkv bf16 D{d}"] = fbwd(d, 1, 1)
        smem[f"flash_dbias bf16 D{d}"] = fdb(d, 1)
        smem[f"flash_dbias fp32 D{d}"] = fdb(d, 0)
        smem[f"quant_bwd_dq D{d}"] = qbwd(d, 0)
        smem[f"quant_bwd_dkv D{d}"] = qbwd(d, 1)
        smem[f"quant_attn_fwd D{d}"] = qfwd(d)
        smem[f"ring_fwd_step bf16 D{d}"] = rfwd(d, 1)
        smem[f"ring_bwd_dq bf16 D{d}"] = rbwd(d, 0, 1)
        smem[f"ring_bwd_dkv bf16 D{d}"] = rbwd(d, 1, 1)
        smem[f"ring_fwd_step fp32 D{d}"] = rfwd(d, 0)
        smem[f"ring_bwd_dq fp32 D{d}"] = rbwd(d, 0, 0)
        smem[f"ring_bwd_dkv fp32 D{d}"] = rbwd(d, 1, 0)
        smem[f"flash_bwd_dq fp32 D{d}"] = fbwd(d, 0, 0)
        smem[f"flash_bwd_dkv fp32 D{d}"] = fbwd(d, 1, 0)
        smem[f"fused_qattn D{d}"] = fq(d)
        for tq in (1, 16):  # the serving group of 2: 2 or 32 query rows
            smem[f"flash_decode bf16 D{d} Tq{tq}"] = fdec(d, 2 * tq, tq, 1)
    for d in (300, 512, 1024):  # the wide bodies (the forward's column-slice pass)
        smem[f"flash_fwd bf16 D{d}"] = fwd(d, 1)
        smem[f"flash_fwd fp32 D{d}"] = fwd(d, 0)
        smem[f"flash_bwd_dq bf16 D{d}"] = fbwd(d, 0, 1)
        smem[f"flash_bwd_dkv bf16 D{d}"] = fbwd(d, 1, 1)
        smem[f"flash_bwd_dq fp32 D{d}"] = fbwd(d, 0, 0)
        smem[f"flash_bwd_dkv fp32 D{d}"] = fbwd(d, 1, 0)
        smem[f"flash_dbias bf16 D{d}"] = fdb(d, 1)
        smem[f"flash_dbias fp32 D{d}"] = fdb(d, 0)
    out = {"kernels": kernels, "dynamic_smem_bytes": smem}
    emit({"phase": "sass", **out})
    record["sass"] = out


DESIGN = {
    "flash_fwd": "tensor cores, the forward body of csrc/fwd_tc.cuh (fwd_tc_kernel: 4 warps x "
                 "16 query rows, K/V tiles double-buffered by cp.async, a K-only pre-pass over "
                 "the first 512 keys, or with a bias over every visible tile, seeding the running "
                 "max, P from the S accumulators); bf16 "
                 "inputs: mma.sync m16n8k16 bf16->fp32, Q fragments in registers, 64-key tiles, "
                 "D <= 256; fp32/fp16 inputs: 3xTF32 (each operand split into tf32 big and small "
                 "parts, three mma.sync m16n8k8 tf32->fp32 a product, big·big and the small "
                 "products in separate score accumulators, each tile's P·V added by an fp32 "
                 "add, P's keys permuted inside each 8-key step so the accumulators are the A "
                 "fragment), 32-key fp32 tiles, D <= 256 (at D 129-256: 8 warps on 128 query "
                 "rows, 16-key tiles); with a BlockMask the SPARSE instantiation walks the "
                 "compacted key row of the block's map query tile, its key tiles from each map "
                 "tile's first key, the bias read only on tiles that are not FULL; with RoPE "
                 "tables the ROPE instantiation rotates Q (rotate-half, fp32) as it stages it "
                 "and each staged K tile in shared memory before any product reads it, a "
                 "barrier after; above D 256 the wide body (csrc/wide_tc.cuh fwd_wide_kernel, "
                 "two launches: a row-max pass, then one block per 256-column slice of out, "
                 "128 in fp32; S built up through 128-column depth chunks, 64 in fp32, in "
                 "three cp.async buffers, the 64-row Q tile resident where it fits; P rounded "
                 "against the final max; dense walk only)",
    "flash_bwd_dq": "tensor cores, the dQ body of quant_bwd_dq (csrc/bwd_tc.cuh dq_tc_kernel) "
                    "with a dense load stage (4 warps x 16 query rows, q·scale and dO staged "
                    "once, K/V key tiles copied by cp.async two steps ahead into three padded "
                    "buffers read in place); bf16 inputs: mma.sync m16n8k16 bf16->fp32, 64-key "
                    "tiles at D 64; fp32/fp16 inputs: 3xTF32 (each operand split into tf32 big "
                    "and small parts, three mma.sync m16n8k8 tf32->fp32 a product, big·big and "
                    "the small products in separate accumulators, each 32-key tile's dQ product "
                    "added to the running sum by an fp32 add), 32-key fp32 tiles (at D 129-256: "
                    "8 warps, each forming S and dP over half the depth and owning that half "
                    "of dQ, the halves' partials added in shared memory; 16-key tiles in two "
                    "staging buffers copied one step ahead); with a BlockMask the SPARSE "
                    "instantiation walks the compacted key row (fetch_kv) of its map query tile "
                    "in order; above D 256 dq_wide_kernel (csrc/wide_tc.cuh: one block per "
                    "256-column slice of dQ, 128 in fp32, S and dP built up through 64-column "
                    "depth chunks, 32 in fp32, of Q, dO, K and V)",
    "flash_bwd_dkv": "tensor cores, the dK/dV body of quant_bwd_dkv (csrc/bwd_tc.cuh "
                     "dkv_tc_kernel) with a dense load stage (4 warps x 16 keys, 8 at D 256; K/V "
                     "staged once, Q and dO 32-row tiles copied by cp.async two steps ahead into "
                     "three padded buffers, the raw Q read in place for dK, q·scale for Sᵀ "
                     "converted one step ahead); bf16 inputs: mma.sync m16n8k16 bf16->fp32; "
                     "fp32/fp16 inputs: 3xTF32 as flash_bwd_dq, each query tile's dK and dV "
                     "products added to the running sums by fp32 adds, fp32 tiles (at D 129-256: "
                     "8 warps on 32 keys, each forming Sᵀ and dPᵀ over a quarter of the depth and "
                     "owning that quarter of dK and dV, the partials added in shared memory; "
                     "16-row query tiles); with a BlockMask the SPARSE instantiation walks, for "
                     "each query head of its GQA group, that head's compacted query row "
                     "(fetch_q), the group summed in registers; above D 256 dkv_wide_kernel "
                     "(csrc/wide_tc.cuh: one block per 128-column slice of dK and dV, Sᵀ and "
                     "dPᵀ built up through depth chunks of K, V, Q and dO)",
    "flash_dbias": "tensor cores, one body with a product policy (dbias_tc_kernel: 8 warps on "
                   "a 64-query output tile, the dS sum over the bias's broadcast batch and "
                   "heads in registers, the bias tile in shared memory once, Q/dO/K/V in "
                   "32-column chunks double-buffered by cp.async, q·scale formed on the A "
                   "fragments, any D); bf16 inputs: mma.sync m16n8k16 bf16->fp32, 128-key "
                   "tiles; fp32/fp16 inputs: 3xTF32 (three mma.sync m16n8k8 tf32->fp32 a "
                   "product on split operands, each 32-column chunk's three products into one "
                   "zeroed fragment added to S, then dP, by an fp32 add), 64-key tiles, 128 "
                   "registers, two blocks an SM",
    "quant_bwd_dq": "tensor cores, mma.sync m16n8k16 bf16->fp32 (csrc/bwd_tc.cuh dq_tc_kernel: "
                    "4 warps x 16 query rows, Q and dO dequantized once, raw int8/int4 K/V key "
                    "tiles double-buffered by cp.async and dequantized to bf16 in shared memory, "
                    "dS fed from the accumulators); with a BlockMask the SPARSE instantiation "
                    "walks the compacted key row (fetch_kv) of its map query tile in order",
    "quant_bwd_dkv": "tensor cores, mma.sync m16n8k16 bf16->fp32 (csrc/bwd_tc.cuh dkv_tc_kernel: "
                     "4 warps x 16 keys, 8 warps at D 256 each owning half the columns, K/V "
                     "dequantized once, raw int8/int4 Q and dO tiles double-buffered by cp.async "
                     "and dequantized to bf16 in shared memory, Pᵀ and dSᵀ fed from the "
                     "accumulators); with a BlockMask the SPARSE instantiation walks each GQA "
                     "head's compacted query row (fetch_q) in turn, the corr row and the Q-mean "
                     "term at each head's own first and last walked tile",
    "quant_attn_fwd": "tensor cores: QKᵀ by mma.sync m16n8k32 s8->s32 (exact), P·V by mma.sync "
                      "m16n8k16 bf16->fp32 (8 warps x 16 query rows, Q fragments in registers at "
                      "D <= 128, int8 K/V 64-key tiles and scales in three cp.async buffers two "
                      "tiles ahead, each V tile dequantized once a block a step ahead into one of "
                      "two padded bf16 tiles, P from the score accumulators in 16-key chunks; two "
                      "passes: QKᵀ alone for the exact row max, then P·V); instantiations of "
                      "their own for INT4 codes (unpacked a 4-byte word a thread into the int8 "
                      "tiles as they are staged) with the corr row, and for ASYMMETRIC zero "
                      "points (streamed with the key tile; P·V on bf16(p·sv) and the V codes); "
                      "with a BlockMask the SPARSE instantiations walk the block's compacted key "
                      "row (fetch_kv) in both passes, the bias read only on tiles not FULL",
    "fused_qattn": "tensor cores: QKᵀ by mma.sync m16n8k8 f64 (DMMA; each score an exact double "
                   "sum of bf16 products rounded once, as the plain version), P·V by mma.sync "
                   "m16n8k16 bf16->fp32 (12 warps x 16 query rows at D 64, 8 at D 128 and 256, Q "
                   "quantized in the block, its A fragments as double in registers at D 64, the "
                   "Q tile bf16 at D 256; the dequantized bf16 K̃/Ṽ tiles (64 keys, 32 at D 256) "
                   "and the cc row in three cp.async buffers two tiles ahead, K̃ as double once "
                   "a block at D 64; two passes: QKᵀ alone for the exact row max, then P·V); "
                   "the means, K/V quantize and cc-row kernels on the CUDA cores; BLOCK and "
                   "ASYMMETRIC through a pre-pass of two CUDA-core kernels (rows, then groups) "
                   "that quantizes Q, K and V, Q then read as a dense bf16 Q; with a "
                   "BlockMask the SPARSE instantiation walks the block's compacted key row "
                   "(fetch_kv) in both passes, the K/V means over the tile each map slice "
                   "fills first",
    "quant_rows": "CUDA cores, a bytes-bound pass (quant_rows_vec_kernel: a row over the fewest "
                  "lanes that hold it at 16 elements a lane in 16-byte bf16 rows, 8 otherwise: "
                  "4 lanes at D 64 bf16, so a warp has 8 rows at once; 16-byte loads, narrower "
                  "where D or an address is not 16-byte aligned; the next row group loaded "
                  "while one is quantized; each warp a contiguous run of rows, the channel "
                  "mean held while the head does not change; a grid of the blocks the card "
                  "holds; the absmax a shuffle reduction over the row's lanes, codes by the "
                  "IEEE-exact quotient from the row's rounded reciprocal and two FMA "
                  "corrections, rounded and clipped on the FP32 pipes; VEC-byte code stores, "
                  "INT4 packed through shared memory; the rotation a Walsh-Hadamard butterfly "
                  "in double over the row's registers and lanes)",
    "ring_fwd_step": "tensor cores, the forward body of flash_fwd (csrc/fwd_tc.cuh fwd_tc_kernel) "
                     "in ring mode: the step's global-position mask reduced on the host to the "
                     "band plus a first visible query row and a key limit, hidden tiles skipped; "
                     "for each block_k group of keys a K-only pre-pass for the group's row max, "
                     "then P (rounded to V's type against it) and P·V; merged into (o, lse) by "
                     "their one owner; bf16 inputs mma.sync m16n8k16 bf16->fp32, fp32 3xTF32 "
                     "(fp16 computed as fp32), D <= 256",
    "ring_bwd_dkv": "tensor cores, the dK/dV body of flash_bwd_dkv (csrc/bwd_tc.cuh "
                    "dkv_tc_kernel with the dense load stages of csrc/bwd_dense.cuh) in ring "
                    "mode: the step's global-position mask reduced on the host to the band plus "
                    "a first visible query row and a key limit, hidden tiles skipped, dK/dV "
                    "folded into the travelling fp32 buffers by their one owner; bf16 inputs "
                    "mma.sync m16n8k16 bf16->fp32, fp32 3xTF32 (fp16 computed as fp32), D <= 256",
    "ring_bwd_dq": "tensor cores, the dQ body of flash_bwd_dq (csrc/bwd_tc.cuh dq_tc_kernel) "
                   "in ring mode as ring_bwd_dkv, dQ folded into the fp32 accumulator; bf16 "
                   "inputs mma.sync m16n8k16 bf16->fp32, fp32 3xTF32, D <= 256",
    "flash_decode": "tensor cores, one launch (flash_decode_tc_kernel: the splits of a (batch, "
                    "kv-head, row group) are the c blocks of a thread-block cluster, c <= 8 chosen "
                    "by the occupancy calculator (7 at the serving geometry), each walking its "
                    "cache rows in 64-row stages through a cp.async ring (4 stages at D 64, 3 at "
                    "D 128, 2 at D 256), each warp 16 rows a stage with its own running (m, l, "
                    "acc); bf16 q: mma.sync m16n8k16 bf16->fp32, K's B fragments widened from the "
                    "int8 stage in registers (the head dim permuted alike in Q), P from the score "
                    "accumulators, V widened by its warp to bf16 and read by ldmatrix.trans; fp32 "
                    "q: mma.sync m16n8k8 tf32 with q and p·vs split in two; the warps, then the "
                    "splits (over distributed shared memory, in rank order) merged inside the "
                    "launch, deterministic)",
    "mma_probe": "tensor cores, wgmma.mma_async m64nNk16 bf16->fp32 (mma_probe_wg_kernel: one "
                 "warpgroup a work item, a 64 x 128 output tile (64 x 64 at N 64) over a K slice "
                 "of 16-128 columns (256 at N 64), K split by the host's plan to >= 256 items, "
                 "two an SM; a and b^T stored once in 128-byte swizzled shared-memory tiles "
                 "(csrc/wgmma.cuh); rep 0 A from shared memory (SS), every later rep A from "
                 "registers (RS) with eps added in place, one group a rep retired before eps "
                 "is read; the K slices' partials summed in split order by a second kernel)",
}


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
    phase_sass(record, report)

    seconds = {}

    def run(phase):
        t = time.perf_counter()
        out = phase(record)
        seconds[phase.__name__] = time.perf_counter() - t
        return out

    timing, worst = run(phase_kernels)
    bwd_timing, bwd_worst = run(phase_bwd_kernels)
    timing.update(bwd_timing)
    worst.update(bwd_worst)
    path_counts = run(phase_serving)
    run(phase_small_reference)
    d_timing, d_worst = run(phase_decode_kernel)
    timing.update(d_timing)
    worst.update(d_worst)
    path_counts += run(phase_continuous_batching)
    run(phase_small_batching)
    path_counts.append(run(phase_attention_api))
    s_timing, s_worst, s_counts = run(phase_block_sparse)
    for name, t in s_timing.items():
        timing[name]["block_sparse"] = t
        worst[name] = max(worst[name], s_worst[name])
    path_counts += s_counts
    qs_timing, qs_worst, qs_counts = run(phase_quant_block_sparse)
    path_counts += qs_counts
    run(phase_small_training)
    path_counts += run(phase_training)
    q_timing, q_worst = run(phase_quant_kernels)
    timing["quant_attn_fwd"]["variants"] = q_timing.pop("quant_attn_fwd_variants")
    worst["quant_attn_fwd"] = max(worst["quant_attn_fwd"], q_worst.pop("quant_attn_fwd"))
    timing.update(q_timing)
    worst.update(q_worst)
    for name, t in qs_timing.items():  # phase 7b's lines, beside their kernels' own
        timing[name]["quant_block_sparse"] = t
    for name, e in qs_worst.items():
        worst[name] = max(worst[name], e)
    pv_lines, pv_worst, pv_counts = run(phase_pv_int8)
    timing["fused_qattn"]["variants"] += pv_lines["fused_qattn"]
    timing["quant_attn_fwd"]["variants"] += pv_lines["quant_attn_fwd"]
    for name, e in pv_worst.items():
        worst[name] = max(worst[name], e)
    path_counts += pv_counts
    path_counts += run(phase_quant_training)
    path_counts += run(phase_two_pass)
    run(phase_small_quant_training)
    path_counts.append(run(phase_quant_attention_api))
    worst.update(run(phase_ring_kernels))
    run(phase_ring_selfloop)
    r_timing, r_counts = run(phase_ring_full)
    timing.update(r_timing)
    path_counts += r_counts
    p_timing, p_worst, p_counts = run(phase_mma_probe)
    timing.update(p_timing)
    worst.update(p_worst)
    path_counts.append(p_counts)
    rope_timing, rope_worst, rope_counts = run(phase_rope)
    timing["flash_fwd"]["rope"] = rope_timing
    worst["flash_fwd"] = max(worst["flash_fwd"], rope_worst)
    path_counts += rope_counts
    path_counts += run(phase_dit)
    mla_counts, mla_worst = run(phase_mla)
    path_counts += mla_counts
    worst["flash_fwd"] = max(worst["flash_fwd"], mla_worst)
    timing["flash_fwd"]["mla_indexer"] = record["mla"]["forward"]["indexer"]["kernel_check"][
        "kernel_ms"]
    t_counts, t_timing = run(phase_mla_training)
    path_counts += t_counts
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):  # rows 2-3 on the training inputs
        timing[name]["mla_training"] = {model: t[name] for model, t in t_timing.items()}
    path_counts += run(phase_sdpa_override)
    path_counts += run(phase_utilities)
    path_counts += run(phase_mesh)
    w_timing, w_worst, w_counts = run(phase_wide_heads)
    for name, t in w_timing.items():  # rows 1-4 above head_dim 256
        timing[name]["wide_heads"] = t
        worst[name] = max(worst[name], w_worst[name])
    path_counts += w_counts
    emit({"phase": "seconds", "build": build["seconds"], **seconds})
    record["phase_seconds"] = seconds
    launches = collections.Counter()
    for counts in path_counts:
        launches.update(counts)

    src = {"flash_fwd": ("umfa_tpu_torch/csrc/flash_fwd.cu", "umfa_tpu/ops/flash_fwd.py:296"),
           "quant_attn_fwd": ("umfa_tpu_torch/csrc/quant_attn_fwd.cu",
                              "umfa_tpu/ops/quant_attention.py:74"),
           "flash_bwd_dq": ("umfa_tpu_torch/csrc/flash_bwd.cu", "umfa_tpu/ops/flash_bwd.py:84"),
           "flash_bwd_dkv": ("umfa_tpu_torch/csrc/flash_bwd.cu", "umfa_tpu/ops/flash_bwd.py:336"),
           "flash_dbias": ("umfa_tpu_torch/csrc/flash_dbias.cu", "umfa_tpu/ops/flash_bwd.py:628"),
           "quant_rows": ("umfa_tpu_torch/csrc/quant_rows.cu", "umfa_tpu/ops/quant_fused.py:40"),
           "fused_qattn": ("umfa_tpu_torch/csrc/fused_qattn.cu",
                           "umfa_tpu/ops/quant_fused_attn.py:206"),
           "quant_bwd_dq": ("umfa_tpu_torch/csrc/quant_bwd.cu", "umfa_tpu/ops/quant_bwd.py:101"),
           "quant_bwd_dkv": ("umfa_tpu_torch/csrc/quant_bwd.cu", "umfa_tpu/ops/quant_bwd.py:339"),
           "flash_decode": ("umfa_tpu_torch/csrc/flash_decode.cu",
                            "umfa_tpu/serving/decode_kernel.py:38"),
           "ring_fwd_step": ("umfa_tpu_torch/csrc/ring_attn.cu",
                             "umfa_tpu/parallel/ring_pallas.py:99"),
           "ring_bwd_dkv": ("umfa_tpu_torch/csrc/ring_attn.cu",
                            "umfa_tpu/parallel/ring_pallas.py:529"),
           "ring_bwd_dq": ("umfa_tpu_torch/csrc/ring_attn.cu",
                           "umfa_tpu/parallel/ring_pallas.py:529"),
           "mma_probe": ("umfa_tpu_torch/csrc/mma_probe.cu", "scripts/d64_ab.py:64")}
    kernels = [
        {"name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
         "launches": launches[name], "max_abs_err": worst[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"],
         "design": DESIGN.get(name, "CUDA cores, FP32 FMAs"),
         **{key: timing[name][key] for key in ("variants", "block_sparse", "quant_block_sparse",
                                               "rope", "mla_indexer", "mla_training",
                                               "wide_heads")
            if key in timing[name]}}
        for name in src
    ]
    kernels[[k["name"] for k in kernels].index("flash_dbias")]["launches_by_dtype"] = {
        key.split("/")[1]: n for key, n in launches.items() if key.startswith("flash_dbias/")}
    kernels[[k["name"] for k in kernels].index("flash_fwd")]["launches_rope"] = (
        launches["flash_fwd/rope"])  # the ROPE instantiation's share of its launches
    for name in ("fused_qattn", "quant_attn_fwd"):  # the PV instantiations' share
        kernels[[k["name"] for k in kernels].index(name)]["launches_pv"] = launches[f"{name}/pv"]
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    missing += [key for key in ("flash_fwd/rope", "fused_qattn/pv", "quant_attn_fwd/pv")
                if launches[key] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the driven paths: {missing}")
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
