"""The forest cells (``drivers/lsh.py``, ``reference/forest.py``): their
tiny runs are correct on the CPU, each fault and the control fails the
checks that should catch it, a program without ``forest_view()`` stops
before its data is made, the configuration is cut only in size, and the
readers of the forest's stages (``metrics/{descend,gather,fold}_device_ms``,
``forest_build_s``) are right on a hand-made trace and silent where the
program left no forest marker or span."""

import json

import pytest

from perfbench.bench.record import Run
from perfbench.bench.registry import HERE, metric_reader
from perfbench.bench.trace import Trace
from perfbench.bench.traffic import Window
from perfbench.drivers import lsh
from perfbench.reference.peaks import packed_scan_bound
from perfbench.tests.conftest import ROOT, make_tiny, run_tiny
from perfbench.tests.test_perfbench_discovery import holds_its_declaration

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = ("wiki300-forest-bulk", "wiki300-forest-auto")
# the checks each fault and the control must fail
CAUGHT = {"stale": {"dist_err"}, "half": {"rank_gap"}, "altered": {"dist_err"},
          "wrong_side": {"side_miss"}, "big_leaf": {"leaf_stray"},
          "control": {"dist_err"}}


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path, bench=BENCH)


@pytest.mark.parametrize("cell", CELLS)
def test_the_entries_resolve(tiny, cell):
    cfg = json.loads((HERE / "configs" / "wiki300-forest-t8.json").read_text())
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert (cfg["source"], cfg["reduced"]) == (entry["source"], entry["reduced"])
    holds_its_declaration(tiny, next(w for w in BENCH["workloads"] if w["name"] == cell))
    e2e = [m["name"] for m in tiny.metrics(cell, trace=False)]
    assert e2e == ["qps", "latency_p95_ms", "recall_at_10", "setup_s"]
    per_layer = [m["name"] for m in tiny.metrics(cell, trace=True)]
    assert per_layer == ["kernel_b_roofline", "device_idle_share", "descend_device_ms",
                         "gather_device_ms", "fold_device_ms", "forest_build_s"]
    for m in tiny.metrics(cell, trace=True):
        mod = metric_reader(m["name"])
        assert (mod.SOURCE, mod.UNIT, mod.BETTER, mod.LAYER, mod.MOVES) == \
            tuple(m[k] for k in ("source", "unit", "better", "layer", "moves"))
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_the_tiny_run_is_correct(tiny, cell):
    rc, res, err = run_tiny(tiny, cell, seed=2 ** 40 + 3)
    assert rc == 0 and res["correct"] is True, err[-2000:]
    assert list(res["checks"]) == list(lsh.CHECKS)
    assert res["metrics"]["recall_at_10"]["value"] > 0.4


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("broken", sorted(CAUGHT))
def test_each_fault_fails_its_checks(tiny, cell, broken):
    system, fault = ("control", None) if broken == "control" else ("program", broken)
    rc, res, _ = run_tiny(tiny, cell, seed=91, system=system, fault=fault)
    assert rc == 0 and res["correct"] is False
    failed = {n for n, c in res["checks"].items() if not c["value"] <= c["limit"]}
    assert CAUGHT[broken] <= failed, res["checks"]


def test_a_program_without_the_view_stops_soon(tiny, monkeypatch):
    from vers_tpu_torch import ANNIndex

    monkeypatch.delattr(ANNIndex, "forest_view")
    with pytest.raises(RuntimeError, match="forest_view"):
        run_tiny(tiny, CELLS[0])


def test_tiny_cuts_only_sizes():
    cfg = json.loads((HERE / "configs" / "wiki300-forest-t8.json").read_text())
    t = lsh.tiny(cfg)
    assert list(t) == list(cfg)
    assert (t["rows"], t["dim"], t["generator"]["clusters"]) == (3000, 24, 16)
    assert t["lsh"] == dict(cfg["lsh"], num_trees=4, max_node_size=32)
    # the published deployment: LSHConfig's defaults, nothing reduced
    from vers_tpu_torch.config import LSHConfig

    default = LSHConfig()
    assert cfg["lsh"] == dict(num_trees=default.num_trees,
                              max_node_size=default.max_node_size, seed=default.seed)
    assert (cfg["rows"], cfg["dim"], cfg["reduced"]) == (999994, 300, [])


def _mark(i, t):
    return (f"void vers::trace::mark<{i}>()", t, t + 0.001)


def _call(t0, trees=2):
    """One forest call from ``t0`` (seconds): the descent, then per tree
    the view gather, the binned search's sort, scan (kernel B), merge and
    end, and the fold; then the id map and the result copy."""
    device = [_mark(9, t0), ("gemv", t0 + 0.001, t0 + 0.01), ("gather", t0 + 0.008, t0 + 0.02)]
    t = t0 + 0.02
    for _ in range(trees):
        device += [_mark(10, t), ("index_select", t + 0.001, t + 0.011),
                   _mark(1, t + 0.011), ("sort", t + 0.012, t + 0.015),
                   _mark(2, t + 0.015),
                   ("void vers::pscan::packed_scan_kernel<true, false>()", t + 0.016, t + 0.03),
                   _mark(3, t + 0.03), _mark(4, t + 0.031),
                   _mark(11, t + 0.032), ("topk", t + 0.033, t + 0.036)]
        t += 0.036
    device += [_mark(12, t), ("Memcpy DtoH", t + 0.001, t + 0.01)]
    host = [("enqueue", t0, t0 + 0.01), ("vers/lsh.search", t0, t0 + 0.005),
            ("drain", t0 + 0.01, t + 0.01)]
    return device, host


def _run(work=True):
    d0, h0 = _call(0.0)
    d1, h1 = _call(0.2)
    trace = Trace(device=d0 + d1, host=h0 + h1, window=(0.0, 0.4), calls=[0, 1])
    w = [dict(live_rows=32768, out_rows=32768, scanned=1_900_000,
              probed_rows=1_999_988, d=300, k=10)] if work else None
    return Run(batch=16384, window=Window(0.0, 1.0), setup_s=1.0, trace=trace,
               work=w, pool_batches=1)


def test_stage_readers_hand_worked():
    run = _run()
    read = {m: metric_reader(m).read(run) for m in
            ("descend_device_ms", "gather_device_ms", "fold_device_ms",
             "kernel_b_roofline")}
    # descend: the union of 0.001-0.01 and 0.008-0.02; gather: 10 ms a
    # tree; fold: 3 ms a tree (each between its marker and the next)
    assert read["descend_device_ms"] == pytest.approx(19.0)
    assert read["gather_device_ms"] == pytest.approx(20.0)
    assert read["fold_device_ms"] == pytest.approx(6.0)
    least = packed_scan_bound(**run.work[0])["bound_ms"]
    assert read["kernel_b_roofline"] == pytest.approx(100.0 * least / 28.0)
    for m in ("route_device_ms", "probe_device_ms", "beam_device_ms"):
        assert metric_reader(m).read(run) is None  # no such stage here


def test_readers_are_silent_without_the_program_trace():
    run = _run(work=False)
    run.trace.device = [r for r in run.trace.device if "mark" not in r[0]]
    for m in ("descend_device_ms", "gather_device_ms", "fold_device_ms",
              "kernel_b_roofline"):
        assert metric_reader(m).read(run) is None, m
    mod = metric_reader("forest_build_s")
    assert mod.seconds({}) is None
    assert mod.seconds({"lsh.build": dict(count=1, total_ns=21_500_000_000,
                                          max_ns=0)}) == pytest.approx(21.5)
