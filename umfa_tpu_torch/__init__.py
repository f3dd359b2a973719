"""PyTorch / CUDA port of umfa_tpu for NVIDIA Hopper (H100).

The JAX package `umfa_tpu` stays the reference; this package mirrors its
layout module by module and imports nothing of it (nor JAX). Kernels are
hand-written CUDA C++ under `csrc/`, built with nvcc at first use
(`_kernels.py`); every kernel wrapper runs its plain PyTorch version when the
tensors it is given lie on the CPU.

Ported so far: the serving path of the GPT model (`models/gpt.py`) with the
dense and the INT8 KV cache, through `ops/flash_fwd.py` and
`ops/quant_attention.py`.
"""
