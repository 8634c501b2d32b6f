"""The HNSW cell (``drivers/hnsw.py``, ``reference/hnsw.py``): its tiny
run is correct on the CPU, each of its faults and its control fails the
checks that should catch it, so does a run that serves another policy
than the configuration records, its configuration is cut only in size,
and the readers of the HNSW stages (``metrics/{route,beam,rescore}_device_ms``,
``route_roofline``, ``hnsw_build_s``) are right on a hand-made trace and
silent where the program left no HNSW marker or span."""

import json

import pytest

from perfbench.bench.record import Run
from perfbench.bench.registry import HERE, metric_reader
from perfbench.bench.trace import Trace
from perfbench.bench.traffic import Window
from perfbench.drivers import hnsw
from perfbench.reference.route import route_scan_bound
from perfbench.tests.conftest import ROOT, make_tiny, run_tiny
from perfbench.tests.test_perfbench_discovery import holds_its_declaration

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "wiki300-hnsw-bulk"
# the checks each fault and the control must fail
CAUGHT = {"stale": {"dist_err"}, "half": {"dist_err"}, "altered": {"dist_err"},
          "short_beam": {"recall_gap"}, "random_edges": {"recall_gap", "graph_stray"},
          "control": {"dist_err"}}


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path, bench=BENCH)


def test_the_entries_resolve(tiny):
    """The cell's entries in ``BENCHMARK.json``: its configuration's
    file, its declaration, and every reader it reports."""
    cfg = json.loads((HERE / "configs" / "wiki300-hnsw-m24.json").read_text())
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert (cfg["source"], cfg["reduced"]) == (entry["source"], entry["reduced"])
    holds_its_declaration(tiny, next(w for w in BENCH["workloads"] if w["name"] == CELL))
    e2e = [m["name"] for m in tiny.metrics(CELL, trace=False)]
    assert e2e == ["qps", "latency_p95_ms", "recall_at_10", "setup_s"]
    for m in tiny.metrics(CELL, trace=True):
        mod = metric_reader(m["name"])
        assert (mod.SOURCE, mod.UNIT, mod.BETTER, mod.LAYER, mod.MOVES) == \
            tuple(m[k] for k in ("source", "unit", "better", "layer", "moves"))
        assert m["moves"] in e2e


def test_the_tiny_run_is_correct(tiny):
    rc, res, err = run_tiny(tiny, CELL, seed=2 ** 40 + 3)
    assert rc == 0 and res["correct"] is True, err[-2000:]
    assert list(res["checks"]) == list(hnsw.CHECKS)
    assert res["metrics"]["recall_at_10"]["value"] > 0.8


def test_another_serving_policy_is_not_correct(tmp_path, capsys):
    """A run whose index serves another inline width than the
    configuration's ``resolved`` one fails ``graph_stray``, though its
    answers are sound."""
    reg = make_tiny(tmp_path, bench=BENCH)
    path = tmp_path / "configs" / "wiki300-hnsw-m24.json"
    cfg = json.loads(path.read_text())
    cfg["serving"]["nav_inline_dp"] = 8
    path.write_text(json.dumps(cfg))
    rc, res, _ = run_tiny(reg, CELL, seed=2 ** 40 + 3)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["graph_stray"]["value"] == 1
    assert res["checks"]["dist_err"]["value"] < 1e-5
    assert "is not the configuration's" in capsys.readouterr().err


@pytest.mark.parametrize("broken", sorted(CAUGHT))
def test_each_fault_fails_its_checks(tiny, broken):
    system, fault = ("control", None) if broken == "control" else ("program", broken)
    rc, res, _ = run_tiny(tiny, CELL, seed=91, system=system, fault=fault)
    assert rc == 0 and res["correct"] is False
    failed = {n for n, c in res["checks"].items() if not c["value"] <= c["limit"]}
    assert CAUGHT[broken] <= failed, res["checks"]


def test_tiny_cuts_only_sizes():
    cfg = json.loads((HERE / "configs" / "wiki300-hnsw-m24.json").read_text())
    t = hnsw.tiny(cfg)
    assert list(t) == list(cfg)
    assert (t["rows"], t["dim"], t["generator"]["clusters"]) == (3000, 24, 16)
    assert t["hnsw"] == dict(cfg["hnsw"], num_layers=4, ef_construction=40,
                             num_neighbours=8)
    assert t["serving"] == dict(cfg["serving"], nav_inline_dp=16, max_degree=12)
    assert t["resolved"] == dict(cfg["resolved"], inline_dp=16, max_degree=12)
    # the published deployment: the four ints, every other field at
    # HNSWConfig's default; only the served layer-0 cap is reduced
    from vers_tpu_torch.config import HNSWConfig

    assert (cfg["hnsw"]["num_layers"], cfg["hnsw"]["ef_construction"],
            cfg["hnsw"]["ef_search"], cfg["hnsw"]["num_neighbours"]) == (12, 100, 32, 24)
    default = HNSWConfig()
    assert all(getattr(default, k) == v for k, v in cfg["serving"].items())
    assert all(getattr(default, k) == cfg["resolved"][k]
               for k in ("nav_dtype", "route_mode", "ef_route"))
    assert cfg["reduced"] == ["max_degree"] and cfg["resolved"]["max_degree"] == 32


def _mark(i, t):
    return (f"void vers::trace::mark<{i}>()", t, t + 0.001)


def _call(t0):
    """One HNSW call from ``t0`` (seconds): the route (the scan and a
    merge), the beam (three chunks with copies and an idle flag read
    between), the rescore and the id map, then the result copy."""
    device = [_mark(5, t0), ("distance_topk_bf16", t0 + 0.001, t0 + 0.02),
              ("topk_values", t0 + 0.015, t0 + 0.03),
              _mark(6, t0 + 0.03), ("gather", t0 + 0.031, t0 + 0.1),
              ("Memcpy DtoD", t0 + 0.1, t0 + 0.11),
              ("gather", t0 + 0.13, t0 + 0.2),
              _mark(7, t0 + 0.2), ("bmm", t0 + 0.201, t0 + 0.25),
              _mark(8, t0 + 0.25), ("Memcpy DtoH", t0 + 0.251, t0 + 0.26)]
    host = [("enqueue", t0, t0 + 0.01), ("vers/hnsw.search", t0, t0 + 0.125),
            ("drain", t0 + 0.01, t0 + 0.26)]
    return device, host


def _run(work=True):
    d0, h0 = _call(0.0)
    d1, h1 = _call(0.3)
    trace = Trace(device=d0 + d1, host=h0 + h1, window=(0.0, 0.56), calls=[0, 1])
    w = [dict(q_n=16384, n1=41547, d=300, k=8)] if work else None
    return Run(batch=16384, window=Window(0.0, 1.0), setup_s=1.0, trace=trace,
               work=w, pool_batches=1)


def test_stage_readers_hand_worked():
    run = _run()
    read = {m: metric_reader(m).read(run) for m in
            ("route_device_ms", "beam_device_ms", "rescore_device_ms",
             "route_roofline", "program_idle_ms")}
    # route: the union of 0.001-0.02 and 0.015-0.03; beam: 0.031-0.11 and
    # 0.13-0.2 (the copy inside it counts, the idle stretch does not)
    assert read["route_device_ms"] == pytest.approx(29.0)
    assert read["beam_device_ms"] == pytest.approx(149.0)
    assert read["rescore_device_ms"] == pytest.approx(49.0)
    least = route_scan_bound(16384, 41547, 300, 8)["bound_ms"]
    assert read["route_roofline"] == pytest.approx(100.0 * least / 29.0)
    # the idle 0.11-0.13 lies under hnsw.search in both calls
    assert read["program_idle_ms"] == pytest.approx(20.0)
    for m in ("probe_device_ms", "scan_device_ms", "merge_device_ms"):
        assert metric_reader(m).read(run) is None  # no binned search here


def test_route_bound_is_kernel_as_bf16_default():
    """One bf16 product a (query, layer-1 row) pair at 989 TFLOP/s
    against the bytes at 3.35 TB/s: 16384 queries over the 1M-row
    index's 41,547 layer-1 rows are bound by operations, 0.413 ms (the
    bound of PERF.md's kernel table), the program's own arithmetic."""
    b = route_scan_bound(16384, 41547, 300, 8)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(2 * 16384 * 41547 * 300 / 989e12 * 1e3)
    assert round(b["bound_ms"], 3) == 0.413
    from vers_tpu_torch.utils.roofline import distance_topk_bound

    assert b == distance_topk_bound(16384, 41547, 300, 8, "bf16", "default")


def test_readers_are_silent_without_the_program_trace():
    run = _run(work=False)
    run.trace.device = [r for r in run.trace.device if "mark" not in r[0]]
    run.trace.host = [r for r in run.trace.host if not r[0].startswith("vers/")]
    for m in ("route_device_ms", "beam_device_ms", "rescore_device_ms",
              "route_roofline", "program_idle_ms"):
        assert metric_reader(m).read(run) is None, m
    assert metric_reader("route_roofline").read(_run(work=False)) is None
    mod = metric_reader("hnsw_build_s")
    assert mod.seconds({}) is None
    assert mod.seconds({"hnsw.build": dict(count=1, total_ns=61_500_000_000,
                                           max_ns=0)}) == pytest.approx(61.5)
