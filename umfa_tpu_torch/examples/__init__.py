"""Runnable examples of the port, torch versions of the repository's
`examples/*.py` at the same sizes and with the same flows. Each module has
`main(argv=None)` with `--device` (default: the card) and runs only as a
script:

    python -m umfa_tpu_torch.examples.quickstart
    python -m umfa_tpu_torch.examples.serving_demo
    python -m umfa_tpu_torch.examples.torch_sdpa_replacement
    python -m umfa_tpu_torch.examples.deepseek_mla_demo
    python -m umfa_tpu_torch.examples.flux_attention_benchmark [--res 256,512,1024]
"""
