"""Every cell end to end on the card, briefly: a result line, correct, and
the device named. Run on the chip with
``python -m pytest wgbench/tests -q -m cuda``; skipped without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from wgbench import spec

CELLS = spec.cells(spec.load_benchmark())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "wgbench.run", "--workload", name, "--seed",
                          "4000000007", "--seconds", "2", "--trace", "0"], capture_output=True,
                         text=True, cwd=spec.root_of(), timeout=1200, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", out.stderr[-3000:]
    assert list(res)[-1] == "checks"
