"""The comparison that decides ``correct``, driven through a whole run at
a tiny grid on the CPU: a sound run is correct; the control (the plain
reference in the next lower width, in the program's place) and each fault
planted under the timed path (``benchmark/faults.py``) are not."""

import pytest

from cellbench_tiny import run_tiny, spec

from benchmark import faults

CELLS = [w["name"] for w in spec()["workloads"]]

# the faults each cell's limits catch.  A float32 run's step control
# works at its own rounding's level, so a looser accept shows in the
# reference's error only from 16 delta at this grid (8 delta at the
# cell's size); at float64 from 4 delta
STATE = ["unchanged", "half", "half_rows", "altered", "t_drift"]
CAUGHT = [("mr-gradp.f32", f) for f in STATE + ["loose_accept_16"]] + [
    ("mr-gradp.f64", f) for f in STATE + ["loose_accept", "loose_accept_8",
                                          "loose_accept_16"]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_control_is_not(name, monkeypatch):
    rec = run_tiny(name, monkeypatch, control=True)
    assert rec["correct"], rec["numbers"]
    assert not rec["control_correct"], rec["control"]


@pytest.mark.parametrize("name,fault", CAUGHT)
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    rec = run_tiny(name, monkeypatch, plant=faults.FAULTS[fault])
    assert not rec["correct"], rec["numbers"]
