"""`correct` refuses what it must, on the CPU at a size a test run holds:
each cell's control (its entry type's `control`: the simulator's is the
reference in bfloat16 in the program's place) and each fault its entry
type plants under a run that skips the look for a card and drives the
rest, each refused by a check it names (`TESTS.faults`; the simulator's,
by `rows_mismatched` or `rows_missing`: a step that returns its state
unchanged, half of the rows left out with the other half's answers in
their place, and one answer altered where it is produced). (One chip: no
exchange between chips to leave out.) A sound run of the same size is
correct."""
import pytest
import torch

from portbench import control, harness

BENCH = harness.load_bench()
ROOT = harness.ROOT
CELLS = [w["name"] for w in BENCH["workloads"]]


def entry_tests(cell, bench=BENCH, root=ROOT):
    """What the cell's entry type gives the CPU tests (`entries.Tests`)."""
    return harness.entry_module(harness.resolve(bench, cell, root),
                                root).TESTS


FAULTS = [pytest.param(cell, fault, id=f"{cell}-{fault.plant.__name__}")
          for cell in CELLS for fault in entry_tests(cell).faults]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run(cell, bench, root, seed=2**31 + 3):
    return harness.run_cell(cell, seed, 0.0, False, device="cpu",
                            bench=bench, root=root,
                            shrink=entry_tests(cell, bench, root).faults_shrink,
                            log=lambda m: None)


def past(checks, names):
    """The checks among `names` whose value lies past its limit."""
    return [n for n in names if checks[n]["value"] > checks[n]["limit"]]


def check_sound(cell, bench=BENCH, root=ROOT):
    result, checks = run(cell, bench, root)
    assert result["correct"] is True
    assert not past(checks, checks)


def check_control(cell, bench=BENCH, root=ROOT):
    t = entry_tests(cell, bench, root)
    result, checks = control.run(cell, 2**31 + 5, "cpu", bench=bench,
                                 root=root, shrink=t.faults_shrink)
    assert result["correct"] is False
    assert past(checks, t.control_checks)


def check_fault(cell, fault, monkeypatch, bench=BENCH, root=ROOT):
    fault.plant(monkeypatch, entry_tests(cell, bench, root).faults_shrink)
    result, checks = run(cell, bench, root)
    assert result["correct"] is False
    assert past(checks, fault.trips)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    check_sound(cell)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(cell):
    check_control(cell)


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_refused(cell, fault, monkeypatch):
    check_fault(cell, fault, monkeypatch)
