"""The harness finds a configuration, a traffic mix and a per-layer metric
that a change adds as files and `BENCHMARK.json` entries only, and the
committed files keep to the benchmark's contract."""
from __future__ import annotations

import json
import os
import re
import shutil

from port_bench.drivers import track
from port_bench.harness import (
    BENCH_DIR, ROOT, find_cell, load_spec, metric_reader, result,
)
from port_bench.tests.conftest import cpu_context, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _copy_bench(tmp_path) -> str:
    root = str(tmp_path)
    shutil.copytree(BENCH_DIR, os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_added_files_are_found(tmp_path):
    root = _copy_bench(tmp_path)
    bench = os.path.join(root, "port_bench")
    spec = load_spec()
    with open(os.path.join(bench, "configs", "sapien_drawers.json")) as f:
        cfg = json.load(f)
    cfg["obj"]["main_axis"] = [1, 1, 1]          # another category's joints
    with open(os.path.join(bench, "configs", "new_cfg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "points_b8.json")) as f:
        traffic = json.load(f)
    traffic.update(streams=4, motion_rad=0.05)
    with open(os.path.join(bench, "traffic", "new_mix.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "metrics", "new_metric.py"), "w") as f:
        f.write("def read(run):\n    return 2.0 * run.steps\n")
    with open(os.path.join(bench, "limits", "drawers_points_b8.json")) as f:
        limits = json.load(f)
    with open(os.path.join(bench, "limits", "new_cell.json"), "w") as f:
        json.dump(limits, f)
    spec["configs"].append({"name": "new_cfg", "source": "x",
                            "file": "port_bench/configs/new_cfg.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new_cell", "config": "new_cfg",
                              "traffic": "new_mix", "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("new_cell")
    spec["per_layer"].append({"name": "new_metric", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "tracking loop",
                              "moves": "frames_per_s",
                              "workloads": ["new_cell"]})
    cell = find_cell(spec, "new_cell", root)
    assert cell.config["obj"]["main_axis"] == [1, 1, 1]
    assert cell.traffic["streams"] == 4
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert metric_reader("new_metric", cell.bench_dir)(
        type("R", (), {"steps": 3})()) == 6.0
    small = tiny_cell("new_cell", root=root, spec=spec)
    out = track.run(cpu_context(small, trace=True))
    line, _ = result(small, out, True)
    assert line["metrics"]["new_metric"]["value"] == 2.0 * out.run.steps


def test_benchmark_json_keeps_the_contract():
    spec = load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["port_bench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert c["file"].startswith("port_bench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        names.add(c["name"])
    used = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and w["config"] in names
        used.add(w["config"])
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH_DIR, "limits",
                                           w["name"] + ".json"))
    assert used == names
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
    assert len(json.dumps(spec)) < 64 * 1024
