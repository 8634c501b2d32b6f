"""Every name in BENCHMARK.json resolves to a file of its own, each cell
holds what its driver declares, and a new cell, or a configuration of
another index, is picked up from new files alone."""

import json
import re
import shutil
import sys

import pytest

from perfbench.bench.registry import HERE, Registry, driver, metric_reader
from perfbench.bench.traffic import COMMON

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"])) \
        == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = ROOT / cfg["file"]
    assert path.parent == HERE / "configs" and path.stem == cfg["name"]
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    driver(data["index"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def holds_its_declaration(reg, entry):
    """The cell of ``entry`` (a ``workloads`` entry) as ``reg`` finds it,
    checked against what its index module declares: the common traffic
    keys and its own ``TRAFFIC``, exactly its ``CHECKS`` as its limits."""
    c = reg.cell(entry["name"])
    drv = driver(c.config["index"])
    assert c.config["name"] == entry["config"]
    assert set(COMMON) | set(drv.TRAFFIC) <= set(c.traffic)
    assert set(c.limits) == set(drv.CHECKS)
    assert "program" in drv.SYSTEMS and callable(drv.tiny) and callable(drv.run)
    assert "limits" not in c.traffic and c.traffic["traffic"] == entry["traffic"]
    e2e = reg.metrics(entry["name"], trace=False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert reg.metrics(entry["name"], trace=True)
    return c


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(cell):
    holds_its_declaration(Registry(), cell)


def test_ivf_driver_declares_its_check():
    """What every IVF cell is held to, through the IVF driver: ``nprobe``,
    ``builds`` and exactly the five limits; its tiny sizes as the CPU tests had them."""
    from perfbench.drivers import ivfflat

    assert ivfflat.CHECKS == ("assign_gap", "dist_err", "rank_gap", "stray_ids",
                              "cost_gap")
    assert ivfflat.TRAFFIC == ("nprobe", "builds")
    assert ivfflat.FAULTS == ("stale", "half", "altered", "no_lloyd")
    assert ivfflat.SYSTEMS == ("program", "control")
    for cfg in BENCH["configs"]:
        c = json.loads((ROOT / cfg["file"]).read_text())
        t = ivfflat.tiny(c)
        assert list(t) == list(c)  # the same keys in the same order: the same bytes
        assert t == dict(c, rows=3000, dim=24, ivf=dict(c["ivf"], nlist=32),
                         generator=dict(c["generator"], clusters=16))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(m):
    mod = metric_reader(m["name"])
    assert (mod.SOURCE, mod.UNIT, mod.BETTER) == (m["source"], m["unit"], m["better"])
    assert callable(mod.read)
    if "layer" in m:
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for w in m.get("workloads", []):
        assert w in [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_of_its_cells(m):
    """Each cell that reports a per-layer metric reports the end-to-end
    metric it moves: ``enqueue_us`` moves ``qps`` in the bulk cells and
    ``enqueue_us.online`` moves ``qps.online`` in the online cell."""
    reg = Registry()
    cells = [w["name"] for w in BENCH["workloads"]
             if m in reg.metrics(w["name"], trace=True)]
    assert cells
    for cell in cells:
        assert m["moves"] in [e["name"] for e in reg.metrics(cell, trace=False)], cell


def test_new_cell_from_new_files_only(tmp_path):
    """A cell, with its traffic mix and its limits, added as one new
    file and a new entry: nothing that exists is edited."""
    for sub in ("configs", "workloads"):
        shutil.copytree(HERE / sub, tmp_path / sub)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*.json")}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "wiki300-ivf-k100", "config": "wiki300-ivf2048",
                               "traffic": "device-16384-k100", "chips": 1, "why": "k 100"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = json.loads((HERE / "workloads" / "wiki300-ivf-bulk.json").read_text())
    (tmp_path / "workloads" / "wiki300-ivf-k100.json").write_text(
        json.dumps(dict(spec, traffic="device-16384-k100", top_k=100, nprobe=8)))
    reg = Registry(tmp_path, tmp_path / "BENCHMARK.json")
    cell = reg.cell("wiki300-ivf-k100")
    assert cell.traffic["top_k"] == 100 and cell.config["ivf"]["nlist"] == 2048
    assert cell.limits == spec["limits"]
    assert all(p.read_bytes() == b for p, b in before.items())
    with pytest.raises(KeyError):
        reg.cell("no-such-cell")
    with pytest.raises(ValueError):
        reg._json("workloads", "workload", "../BENCHMARK")
    bench["workloads"][-1]["traffic"] = "device-16384-np2"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError):  # the cell file names another mix
        Registry(tmp_path, tmp_path / "BENCHMARK.json").cell("wiki300-ivf-k100")


def test_calibrate_overrides_traffic():
    """``calibrate.py --set KEY=VALUE`` changes any traffic parameter of
    the cell; ``--nprobe N`` is ``--set nprobe=N``; a key the cell lacks
    is refused."""
    from perfbench import calibrate

    base = Registry().cell("wiki300-ivf-bulk").traffic
    args = calibrate.parse(["--workload", "wiki300-ivf-bulk", "--seeds", "1",
                            "--nprobe", "2"])
    assert args.traffic == {"nprobe": 2}
    assert calibrate._Override(args.traffic).cell("wiki300-ivf-bulk").traffic == \
        dict(base, nprobe=2)
    args = calibrate.parse(["--workload", "w", "--seeds", "1", "--set", "nprobe=4",
                            "--set", 'queries="host"', "--set", "trace_start=0.5"])
    assert args.traffic == {"nprobe": 4, "queries": "host", "trace_start": 0.5}
    assert calibrate._Override(args.traffic).cell("wiki300-ivf-bulk").traffic == \
        dict(base, nprobe=4, queries="host", trace_start=0.5)
    with pytest.raises(KeyError):
        calibrate._Override({"ef": 48}).cell("wiki300-ivf-bulk")
    for bad in ("nprobe", "=2", "queries=host"):
        with pytest.raises(SystemExit):
            calibrate.parse(["--workload", "w", "--seeds", "1", "--set", bad])


STUB_CONFIG = {
    "name": "wiki300-stubflat", "source": "https://fasttext.cc/docs/en/english-vectors.html",
    "deployment": "a chunked exact scan over wiki-news-300d-1M, for the tests",
    "index": "stubflat", "rows": 999994, "dim": 300, "normalized": True,
    "metric": "sq_euclidean", "precision": "float32",
    "generator": {"corpus_seed": 0, "clusters": 1024, "query_noise": 0.5},
    "reduced": []}
STUB_CELL = {
    "config": "wiki300-stubflat", "traffic": "device-1024-chunk512", "queries": "device",
    "batch": 1024, "pool_batches": 4, "depth": 2, "top_k": 10, "chunk_rows": 512,
    "warmup_calls": 8, "trace_start": 0.3, "trace_calls": 16,
    "limits": {"dist_gap": 1e-05, "order_gap": 1e-05}}
STUB_METRIC = {"name": "stubflat_rank_ms", "unit": "ms", "better": "lower",
               "source": "device_trace", "layer": "stub index (stage rank)",
               "moves": "qps", "workloads": ["wiki300-stubflat-bulk"]}


def test_new_index_from_new_files_only(tmp_path, monkeypatch):
    """A configuration of another index, added as new files and new
    entries alone: its driver (``stub_index.py``, registered as
    ``perfbench.drivers.stubflat``: a new ``drivers/<index>.py``), its
    configuration with no ``ivf`` block, a cell with limits and a traffic
    key of its own, and a per-layer metric that reads a stage of its own
    through ``stage_ms(..., stages=...)``. The IVF cells' tiny runs pass
    beside it, and no file that exists changes."""
    from perfbench.bench import registry
    from perfbench.bench.record import Run
    from perfbench.bench.registry import read_metrics
    from perfbench.bench.trace import Trace
    from perfbench.bench.traffic import Window
    from perfbench.tests import stub_index
    from perfbench.tests.conftest import make_tiny, run_tiny

    tree = [ROOT / "BENCHMARK.json"] + [p for p in sorted(HERE.rglob("*"))
                                        if p.is_file() and "__pycache__" not in p.parts]
    before = {p: p.read_bytes() for p in tree}

    src = tmp_path / "perfbench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(HERE / sub, src / sub)
    monkeypatch.setitem(sys.modules, "perfbench.drivers.stubflat", stub_index)
    shutil.copy(HERE / "tests" / "stub_metric.py", src / "metrics" / "stubflat_rank_ms.py")
    monkeypatch.setattr(registry, "HERE", src)  # metrics/ of the tree with the new files
    (src / "configs" / "wiki300-stubflat.json").write_text(json.dumps(STUB_CONFIG))
    (src / "workloads" / "wiki300-stubflat-bulk.json").write_text(json.dumps(STUB_CELL))
    entry = {"name": "wiki300-stubflat-bulk", "config": "wiki300-stubflat",
             "traffic": "device-1024-chunk512", "chips": 1, "why": "the stub"}
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "wiki300-stubflat", "source": STUB_CONFIG["source"],
                             "file": "perfbench/configs/wiki300-stubflat.json",
                             "reduced": [], "why": "the stub"})
    bench["workloads"].append(entry)
    for m in bench["end_to_end"]:  # the metrics a new cell reports list it
        if m["name"] in ("qps", "latency_p95_ms"):
            m["workloads"].append(entry["name"])
    bench["per_layer"].append(STUB_METRIC)

    reg = make_tiny(tmp_path / "tiny", src, bench)
    c = holds_its_declaration(reg, entry)
    assert "ivf" not in c.config and "nprobe" not in c.traffic
    assert (c.config["rows"], c.config["dim"], c.config["generator"]["clusters"]) \
        == (2000, 16, 8)
    assert (c.traffic["batch"], c.traffic["warmup_calls"], c.traffic["trace_calls"]) \
        == (64, 4, 4)

    rc, res, err = run_tiny(reg, entry["name"])
    assert rc == 0 and res["correct"] is True and res["attempted"] > 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert sorted(res["metrics"]) == ["latency_p95_ms", "qps", "setup_s"]
    assert list(res["checks"]) == list(stub_index.CHECKS)
    assert [line.split()[1] for line in err.strip().splitlines()[-2:]] == \
        list(stub_index.CHECKS)
    rc, res, err = run_tiny(reg, entry["name"], fault="shifted")
    assert rc == 0 and res["correct"] is False and "FAIL" in err

    # the per-layer metric: its stage's markers follow the binned search's
    mod = metric_reader("stubflat_rank_ms")
    assert (mod.SOURCE, mod.UNIT, mod.BETTER, mod.LAYER, mod.MOVES) == \
        tuple(STUB_METRIC[k] for k in ("source", "unit", "better", "layer", "moves"))
    device = [("void vers::trace::mark<5>()", 0.0, 0.001), ("scan_kernel", 0.001, 0.2),
              ("void vers::trace::mark<6>()", 0.2, 0.201), ("rank_kernel", 0.201, 0.5),
              ("void vers::trace::mark<7>()", 0.5, 0.501), ("Memcpy DtoH", 0.501, 0.6)]
    run = Run(batch=64, window=Window(0.0, 1.0), setup_s=1.0,
              trace=Trace(device=device, host=[("enqueue", 0.0, 0.6)],
                          window=(0.0, 0.6), calls=[0]))
    read = read_metrics(reg.metrics(entry["name"], trace=True), run)
    assert read["stubflat_rank_ms"]["value"] == pytest.approx(299.0)
    assert metric_reader("scan_device_ms").read(run) is None  # IVF's stage 2: none
    assert "stubflat_rank_ms" not in [m["name"] for m in reg.metrics(
        "wiki300-ivf-bulk", trace=True)]

    for w in BENCH["workloads"]:
        rc, res, _ = run_tiny(reg, w["name"])
        assert rc == 0 and res["correct"] is True, w["name"]
        assert set(res["checks"]) == set(driver("ivfflat").CHECKS)
    assert all(p.read_bytes() == b for p, b in before.items())
    assert sorted(p for p in HERE.rglob("*") if p.is_file()
                  and "__pycache__" not in p.parts) == tree[1:]
