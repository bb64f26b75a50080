"""The stream cell on the CPU at a small size, through the whole harness:
a cell defined only here (its configuration and traffic written by the
fixture) is found by name and run; the port's CPU path agrees with the
plain reference; the control (the reference in TF32 in the program's
place) and a perturbed output fail the comparison; and each fault the
stream cell can have, planted under the timed path, makes ``correct``
come out false."""

import json
import pathlib
import sys

import pytest
import torch

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
for p in (CHECKOUT, CHECKOUT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import bench, compare  # noqa: E402

SECONDS = 0.3


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """A 16-feature, 512-event cell of the ``hyperplane-d10`` chain: at
    this width and an offered 100 events/s the controller's plan is cut 3
    (only ``x`` crosses the uplink)."""
    root = tmp_path_factory.mktemp("cell")
    cfg = json.loads((bench.HERE / "configs" / "hyperplane-d10.json")
                     .read_text())
    cfg.update(name="hyperplane-d16", reference="hyperplane-d10",
               num_features=16, batch_events=512, offered_rate=100.0,
               plan={"cut": 3, "crossing": ["x"]})
    (root / "hyperplane-d16.json").write_text(json.dumps(cfg))
    mix = json.loads((bench.HERE / "traffic" / "hyperplane-steady.json")
                     .read_text())
    mix["segments"] = [{"batches": 4, "concept": 0}]
    (root / "traffic").mkdir()
    (root / "traffic" / "small-ring.json").write_text(json.dumps(mix))
    # two concepts: DDM raises drift alarms and the learner's response runs
    mix["segments"] = [{"batches": 6, "concept": 0},
                       {"batches": 6, "concept": 1}]
    (root / "traffic" / "drifting-ring.json").write_text(json.dumps(mix))
    spec = {"workloads": [{"name": "stream-d16", "config": "hyperplane-d16",
                           "traffic": "small-ring", "chips": 1, "why": "."},
                          {"name": "stream-d16-drift",
                           "config": "hyperplane-d16",
                           "traffic": "drifting-ring", "chips": 1,
                           "why": "."}],
            "configs": [{"name": "hyperplane-d16",
                         "file": str(root / "hyperplane-d16.json")}],
            "end_to_end": [{"name": "events_per_s", "unit": "events/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "batch_ms_p95.stream", "unit": "ms"}]}
    return {w["name"]: bench.Cell.resolve(spec, w["name"], data=root)
            for w in spec["workloads"]}


@pytest.fixture(scope="module")
def cell(cells):
    return cells["stream-d16"]


@pytest.mark.parametrize("name,seed,seconds",
                         [("stream-d16", 2**31 + 12345, SECONDS),
                          ("stream-d16-drift", 77, 1.5)],
                         ids=["stream-d16", "stream-d16-drift"])
def test_a_cell_defined_only_here_runs_and_is_correct(cells, name, seed,
                                                      seconds):
    r = bench.run_cell(cells[name], seed, seconds, False, "cpu")
    assert r["correct"], r["checks"]
    assert (r["notes"]["drift_alarms"] > 0) == name.endswith("drift")
    assert set(r["metrics"]) == {"events_per_s", "setup_s"}
    assert r["metrics"]["events_per_s"]["value"] > 0
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu"


def test_the_traced_run_reads_its_window(cell):
    r = bench.run_cell(cell, 77, SECONDS, True, "cpu")
    assert r["correct"]
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_control_fails(cell):
    for seed in (5, 2**31 + 7):
        got = cell.system().control(cell, seed, SECONDS, "cpu")
        held = compare.held(got, cell.config["limits"])
        assert not compare.correct(held), got


def test_a_perturbed_state_fails_the_comparison():
    ref = bench.load_file(bench.HERE / "reference" / "hyperplane-d10.py")
    cfg = json.loads((bench.HERE / "configs" / "hyperplane-d10.json")
                     .read_text())
    cfg["num_features"] = 8
    want = ref.init_state(cfg, "cpu")
    got = {k: v.clone() for k, v in want.items()}
    got["learner.w"][3] += 1e-3
    from portbench.systems import stream
    gaps = compare.grouped_gaps(got, want, stream.GROUPS)
    assert gaps["learner"] > cfg["limits"]["learner"]
    assert all(v == 0.0 for k, v in gaps.items() if k != "learner")


def _unchanged(program):
    """A step that returns its state unchanged: the chain's ops keep the
    state they were given."""
    pipe = program.orch.pipeline
    ops = list(pipe.ops)
    i = pipe.names.index("train")
    op = ops[i]
    ops[i] = type(op)(**{**op.__dict__,
                         "fn": lambda st, b, f=op.fn: (st, f(st, b)[1])})
    object.__setattr__(pipe, "ops", tuple(ops))


def _half_batch(program):
    """Half of the batch left out: the orchestrator is fed the first half
    of each batch's rows (the reference sees the whole batch)."""
    orch = program.orch
    real = orch.execute_batch

    def half(step, batch, record_outputs=False):
        n = batch.n // 2
        return real(step, batch.select(slice(0, n)), record_outputs)
    orch.execute_batch = half


def _altered_answer(program):
    """An answer altered where it is produced: one event's error flag
    flipped as the learner writes it."""
    pipe = program.orch.pipeline
    ops = list(pipe.ops)
    i = pipe.names.index("train")
    op = ops[i]

    def fn(st, b, f=op.fn):
        st, out = f(st, b)
        err = out["err"].clone()
        err[0] = 1.0 - err[0]
        return st, {**out, "err": err}
    ops[i] = type(op)(**{**op.__dict__, "fn": fn})
    object.__setattr__(pipe, "ops", tuple(ops))


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_answer],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    r = bench.run_cell(cell, 31, SECONDS, False, "cpu", program_hook=fault)
    assert not r["correct"], r["checks"]


def test_gap_reads_integers_exactly_and_nan_as_infinite():
    a = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert compare.gap(a, a) == 0.0
    assert compare.gap(a, a + 1) == 1.0
    x = torch.tensor([1.0, float("nan")])
    assert compare.gap(x, torch.tensor([1.0, 2.0])) == float("inf")
    assert compare.gap(torch.tensor([1.0, 2.0]),
                       torch.tensor([1.0, 4.0])) == pytest.approx(0.5)
