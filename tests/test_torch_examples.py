"""The port's examples (umfa_tpu_torch/examples/) run end to end on the CPU
through their plain PyTorch paths: each `main(["--device", "cpu", ...])`,
at the reference examples' sizes; the FLUX benchmark at 64px (528 tokens)
and one iteration, for time."""

import importlib

import pytest
import torch

ARGS = {
    "quickstart": [],
    "serving_demo": [],
    "torch_sdpa_replacement": [],
    "deepseek_mla_demo": [],
    "flux_attention_benchmark": ["--res", "64", "--iters", "1"],
}


@pytest.mark.parametrize("name", sorted(ARGS))
def test_example_runs_on_the_cpu(name, capsys):
    mod = importlib.import_module(f"umfa_tpu_torch.examples.{name}")
    mod.main(["--device", "cpu", *ARGS[name]])
    out = capsys.readouterr()
    assert out.out.strip(), name
    if name == "torch_sdpa_replacement":
        errs = [float(line.split("relerr ")[1]) for line in out.out.splitlines()
                if "relerr" in line]
        assert len(errs) == 3 and max(errs) < 1e-4, out.out
    if name == "flux_attention_benchmark":
        assert "64px (seq=528) on cpu" in out.err


def test_examples_default_to_the_card(monkeypatch):
    from umfa_tpu_torch.examples import quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])
