"""The port's entry points run on the CUDA card unless the caller names the
CPU: without a card they raise instead of falling back to the CPU."""

from pathlib import Path

import pytest
import torch

from nautilus_tpu_torch import cli as torch_cli
from nautilus_tpu_torch.core.problem import default_device
from nautilus_tpu_torch.ingest import synthetic as tsyn

CONFIG = Path(__file__).resolve().parents[1] / "config" / "default_config.lua"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
    assert default_device("cpu") == torch.device("cpu")


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["make_problem",
                                   "reverse_traversal_problem"])
def test_synthetic_ingest_raises_without_a_card(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        getattr(tsyn, entry)(seed=1)


def test_synthetic_ingest_runs_on_cpu_when_asked(no_card):
    state, gt = tsyn.make_problem(4, "room", num_beams=90, seed=1,
                                  device="cpu")
    assert state.problem.device == torch.device("cpu")
    assert state.solution.shape == gt.shape == (4, 3)


def test_cli_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_cli.main(["--config_file", str(CONFIG), "--synthetic", "room",
                        "--quiet"])
