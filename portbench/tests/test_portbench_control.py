"""On the card: the control of the closed-map cell comes out not correct,
and the same run with the configuration's precision comes out correct.

The configuration states float32 with TF32 off (the port turns it off on
import); the control turns TF32 on for the port's matrix products, which
moves the chi-square gate's covariances (``gate_miss``).  Marked ``cuda``:
it skips without a card, deciding in its fixture.

    python -m pytest -q -p no:cacheprovider -m cuda \\
        portbench/tests/test_portbench_control.py
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as harness  # noqa: E402

SEED = 2 ** 31 + 9090


@pytest.fixture
def tf32():
    """Set TF32 for the port's matrix products; restore it afterwards."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import nautilus_tpu_torch  # noqa: F401  (turns TF32 off on import)
    harness.cache_env()
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)

    def set_tf32(on):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
    yield set_tf32
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = before


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True])
def test_closed_map_control(tf32, control):
    tf32(control)
    run, judge, _, limits = harness.measure("gdc2020.autolc_map", SEED, 1.0,
                                            False, "cuda")
    checks = judge()
    correct, shown = harness.verdict(run, checks, limits)
    assert correct == (not control), shown
    if control:
        assert checks["gate_miss"] > limits["gate_miss"], shown
