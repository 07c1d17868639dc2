"""The cell `tm5120.stream_f32_3p15db`: the reference's TM5120 tables
(`reference/tm_r45.py`) against frozen vectors (the generator and the
edges, and f32 layered min-sum decodes at 3.15 and 2.75 dB recorded once,
in `vectors_tm5120.json`), checked as `test_reference.py` checks the other
two codes; the cell's judge on the CPU with the timed path broken as
`test_faults.py` breaks it; and its bfloat16 control, on the CPU and, marked
`card`, at the cell's own sizes on the card:

    python -m pytest portbench/tests/test_tm5120.py -q -m card
"""

import json
from pathlib import Path

import pytest

from portbench import control
from portbench.reference import tm_r45  # noqa: F401  (registers TM5120)
from portbench.reference.codes import code, generator_parity

from . import test_card, test_faults, test_reference

CELL = "tm5120.stream_f32_3p15db"
VECTORS = json.loads((Path(__file__).parent / "vectors_tm5120.json").read_text())


def test_tables():
    c = code("TM5120")
    assert (c.edges, c.n_vars, c.n_checks) == (19968, 5632, 1536)
    assert test_reference.sha(generator_parity("TM5120")) == \
        VECTORS["TM5120"]["generator_parity_sha256"]
    assert test_reference.sha(test_reference.edges("TM5120")) == VECTORS["TM5120"]["edges_sha256"]


@pytest.mark.parametrize("case", VECTORS["cases"],
                         ids=lambda v: f"{v['seed']}-{v['frames']}x{v['maxiters']}")
def test_decodes(case):
    test_reference.test_decodes(case)


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_fault_is_caught(fault, monkeypatch):
    test_faults.break_program(monkeypatch, CELL, fault)
    outcome = test_faults.dry(CELL)
    assert not all(c.ok for c in outcome.checks), [(c.name, c.value) for c in outcome.checks]


def test_sound_run_is_correct():
    outcome = test_faults.dry(CELL)
    assert all(c.ok for c in outcome.checks), [(c.name, c.value) for c in outcome.checks]


def test_control_fails(capsys):
    assert control.main(["--workload", CELL, "--control", "bfloat16", "--seeds", "31,32",
                         "--dry-run"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 2 and not any(x["correct"] for x in lines), lines


@pytest.mark.card
def test_cell_runs_correct_on_card(card):
    test_card.test_cell_runs_correct(CELL, card)


@pytest.mark.card
def test_control_counts_wrong_frames_on_card(card):
    """The program's bfloat16 path at the cell's sizes: frames wrong above 0."""
    lines = test_card._run("portbench.control", "--workload", CELL, "--control", "bfloat16",
                           "--seeds", "161803398", "--seconds", "2")
    assert lines and all(x["checks"]["frames_wrong"]["value"] > 0 for x in lines), lines
