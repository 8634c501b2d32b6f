"""Every name in BENCHMARK.json resolves to a file of its own, and a new
cell is picked up from new files alone."""

import json
import re
import shutil

import pytest

from perfbench.bench.registry import HERE, Registry, driver, metric_reader

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


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(cell):
    c = Registry().cell(cell["name"])
    assert c.config["name"] == cell["config"]
    assert {"queries", "batch", "pool_batches", "depth", "top_k", "nprobe",
            "warmup_calls", "trace_start", "trace_calls"} <= set(c.traffic)
    assert set(c.limits) == {"assign_gap", "dist_err", "rank_gap", "stray_ids", "cost_gap"}
    assert "limits" not in c.traffic and c.traffic["traffic"] == cell["traffic"]
    e2e = Registry().metrics(cell["name"], trace=False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert Registry().metrics(cell["name"], trace=True)


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
