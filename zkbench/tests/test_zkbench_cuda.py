"""The control of each cell's correctness check, on the card: the cell as
the benchmark runs it, at its own size, once sound and once with every
proof given one blinding seed (``zkbench/control.py``), which breaks the
configurations' guarantee of fresh blinding. The sound run must come out
correct, the control not. Skips without a CUDA card.

    python -m pytest zkbench/tests/test_zkbench_cuda.py -m cuda -n 0
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from zkbench import control  # noqa: E402

SEED = 2**31 + 4099


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload, seconds", [
    ("withdraw-d16.payroll-b3", 3.0),
    ("audit-varpk-d21.compliance", 4.0),
])
def test_control_is_not_correct_and_the_sound_run_is(card, workload,
                                                     seconds):
    sound = control.run(ROOT, workload, SEED, seconds, sound=True)
    assert sound["correct"] is True, sound["checks"]
    ctl = control.run(ROOT, workload, SEED, seconds, sound=False)
    assert ctl["correct"] is False
    assert ctl["checks"]["proofs_wrong"]["value"] >= 1
