"""On the card (marked `card`; skipped elsewhere): each cell's short run
comes out correct with its result line, and its control comes out not
correct at the cell's own sizes.

    python -m pytest portbench/tests -q -m card
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from .test_faults import CELLS, CONTROLS

ROOT = Path(__file__).resolve().parents[2]


def _run(module, *args):
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell, card):
    line = _run("portbench.run", "--workload", cell, "--seed", "2718281828", "--seconds", "2",
                "--trace", "0")[-1]
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["metrics"]["setup_s"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(cell, card):
    lines = _run("portbench.control", "--workload", cell, "--control", CONTROLS[cell],
                 "--seeds", "161803398", "--seconds", "2")
    assert lines and not any(x["correct"] for x in lines)
