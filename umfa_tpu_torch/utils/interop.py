"""Tensor interop and the SDPA override (port of umfa_tpu/utils/interop.py).

`from_dlpack(x)` takes any DLPack producer (an object with `__dlpack__`
and `__dlpack_device__`: a JAX or NumPy array, a CuPy array, a tensor) as a
torch tensor without a copy where the devices allow; `to_dlpack(t)` gives a
tensor back as a producer that any DLPack consumer takes
(`jax.numpy.from_dlpack`, `numpy.from_dlpack`). Neither imports the other
framework. The reference's `from_torch`/`to_torch` moved torch tensors to
JAX and back; here torch is the framework.

`install_torch_sdpa()` / `use_torch_sdpa()` override
`torch.nn.functional.scaled_dot_product_attention` process-wide so that
any torch model that calls it runs the port's `attention()` (api.py): the
`flash_fwd` kernel, and the dense backward kernels under autograd, on CUDA
tensors; their plain versions on CPU tensors. Dropout, inputs of fewer than
4 dimensions, dtypes other than fp16/bf16/fp32, and mismatched head counts
without `enable_gqa` keep torch's own function, as in the reference. The
port's own code never calls `scaled_dot_product_attention`; a yardstick
that times torch's SDPA must do so with the override removed.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F


def from_dlpack(x) -> torch.Tensor:
    """A DLPack producer as a torch tensor (zero-copy where the devices
    allow: the tensor shares the producer's memory, so writing to it writes
    there). A tensor is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x
    if not hasattr(x, "__dlpack__"):
        raise TypeError(f"from_dlpack takes a DLPack producer, got {type(x).__name__}")
    return torch.from_dlpack(x)


def to_dlpack(t: torch.Tensor):
    """`t` as a DLPack producer (detached: a consumer holds no autograd
    graph), for `jax.numpy.from_dlpack`, `numpy.from_dlpack` and the like."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"to_dlpack takes a torch.Tensor, got {type(t).__name__}")
    return t.detach()


# Refcount for nested installs: the override is removed only when the last
# outstanding uninstaller runs, so an inner `with use_torch_sdpa():` cannot
# tear down an outer scope's override.
_sdpa_lock = threading.Lock()
_sdpa_install_count = 0
_sdpa_native = None


def _set_sdpa(fn) -> None:
    F.scaled_dot_product_attention = fn  # F is torch.nn.functional: one binding


def install_torch_sdpa():
    """Install the process-wide override of
    `torch.nn.functional.scaled_dot_product_attention` (module docstring).
    Returns an `uninstall()` callable. Installs are refcounted: each call
    returns a single-shot uninstaller, and torch's function comes back only
    when every outstanding uninstaller has run."""
    global _sdpa_install_count, _sdpa_native

    def make_uninstall():
        done = False

        def uninstall():
            nonlocal done
            global _sdpa_install_count, _sdpa_native
            with _sdpa_lock:
                if done:
                    return
                done = True
                _sdpa_install_count -= 1
                if _sdpa_install_count == 0 and _sdpa_native is not None:
                    _set_sdpa(_sdpa_native)
                    _sdpa_native = None

        return uninstall

    with _sdpa_lock:
        _sdpa_install_count += 1
        if _sdpa_install_count > 1:
            return make_uninstall()
        native = F.scaled_dot_product_attention
        _sdpa_native = native

    def sdpa(query, key, value, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None,
             enable_gqa=False):
        if (dropout_p != 0.0 or query.dim() != 4
                or query.dtype not in (torch.float16, torch.bfloat16, torch.float32)
                or (not enable_gqa and key.shape[1] != query.shape[1])):
            # torch's semantics: its dropout, its shapes, its dtypes, and its
            # error for mismatched heads without enable_gqa.
            return native(query, key, value, attn_mask=attn_mask, dropout_p=dropout_p,
                          is_causal=is_causal, scale=scale, enable_gqa=enable_gqa)
        return torch_sdpa(query, key, value, attn_mask=attn_mask, is_causal=is_causal,
                          scale=scale)

    sdpa._umfa_override = True
    _set_sdpa(sdpa)
    return make_uninstall()


class use_torch_sdpa:
    """Context manager scoping the SDPA override:

        with use_torch_sdpa():
            out = F.scaled_dot_product_attention(q, k, v)  # the port's kernels
    """

    def __enter__(self):
        self._uninstall = install_torch_sdpa()
        return self

    def __exit__(self, *exc):
        self._uninstall()
        return False


def torch_sdpa(q, k, v, attn_mask=None, is_causal=False, scale=None, **kwargs):
    """SDPA-shaped entry to the port's `attention()`: q (B, Hq, Sq, D), k and
    v (B, Hkv, Sk, D) (GQA when Hq > Hkv); attn_mask a bool mask (True =
    attend) or an additive float bias; `kwargs` go to `attention()`.
    Differentiable in q, k and v."""
    from umfa_tpu_torch.api import attention

    return attention(q, k, v, attn_mask, is_causal=is_causal, scale=scale, **kwargs)
