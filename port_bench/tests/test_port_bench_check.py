"""The check that decides `correct`, on graphs of a few thousand nodes on
the CPU: the program against the reference passes each cell's limits; the
control and each fault a full-batch training cell can have come out not
correct; a run through the harness's control flow with a tiny window.
The look for a card (run.py) is the one part skipped here."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402
from port_bench.reference.follow import as_program, compare  # noqa: E402

NODES = 3000
K8 = {"epochs_per_sync": 8}  # the K loop's body, run eagerly on the CPU
CELLS = [w["name"] for w in harness.load_json("BENCHMARK.json")["workloads"]]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _limited(gaps: dict, limits: dict) -> dict:
    return {k: (gaps[k], v) for k, v in limits.items()}


@pytest.mark.parametrize("cell", CELLS)
def test_program_within_limits(cell):
    run = harness.Setup(cell, 987654321987, "cpu", graph_overrides={"num_nodes": NODES},
                        cfg_overrides=K8)
    observed = run.first_steps()
    run.free_program()
    gaps = compare(observed, run.reference())
    assert all(g <= lim for g, lim in _limited(gaps, run.limits).values()), gaps


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("variant", ["control", "half_batch"])
def test_control_and_half_batch_fail(cell, variant):
    """The reference in the program's place: one precision step below the
    configuration's (each of its file's "controls"), or over half the train
    rows."""
    run = harness.Setup(cell, 13572468, "cpu", graph_overrides={"num_nodes": NODES},
                        program=False)
    kws = ([{"control": c} for c in run.conf["controls"]] if variant == "control"
           else [{"half_batch": True}])
    ref = run.reference()
    for kw in kws:
        gaps = compare(as_program(run.reference(**kw)), ref)
        assert any(g > lim for g, lim in _limited(gaps, run.limits).values()), (kw, gaps)


@pytest.mark.parametrize("cell", CELLS)
def test_run_through_the_harness(cell):
    out = harness.run_cell(cell, 2 ** 31 + 11, 0.2, False, device="cpu",
                           graph_overrides={"num_nodes": NODES}, cfg_overrides=K8)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 16
    manifest = harness.load_json("BENCHMARK.json")
    assert set(out["metrics"]) == {m["name"] for m in manifest["end_to_end"]
                                   if cell in m.get("workloads", [cell])}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_faults_under_the_timed_path_fail(fault):
    """A step that returns its state unchanged, and half the batch left out
    of the mean, planted in the program under the trainer's loop."""
    out = harness.run_cell(CELLS[0], 424242, 0.2, False, device="cpu",
                           graph_overrides={"num_nodes": NODES}, cfg_overrides=K8, fault=fault)
    assert not out["correct"]


def test_traced_run_control_flow(monkeypatch):
    """--trace 1 on the CPU: the profiler hooks at block boundaries, the
    readers return nothing where the trace holds no device operation."""
    monkeypatch.setattr(harness, "TRACE_FROM_BLOCK", 1)
    monkeypatch.setattr(harness, "TRACE_BLOCKS", 2)
    out = harness.run_cell(CELLS[0], 5, 0.2, True, device="cpu",
                           graph_overrides={"num_nodes": NODES}, cfg_overrides=K8)
    assert out["correct"]
    assert set(out["metrics"]) == {"setup.build_s"}
    assert out["device"]["busy_s"] == 0 and "breakdown" in out


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell through run.py, on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import json
    import subprocess

    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0],
                          "--seed", "3", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import subprocess

    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0],
                          "--seed", "3", "--seconds", "2"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
