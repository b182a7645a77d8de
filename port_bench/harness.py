"""The benchmark's shared code: the cells of `BENCHMARK.json`, found by
name, and the run that measures one of them.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name `BENCHMARK.json`
gives it:

  configs/<config>.json    the configuration as it is run, with the name of
                           its plain reference (`reference/<name>.py`)
  traffic/<traffic>.json   the traffic's parameters, read by the driver it
                           names (`drivers/<driver>.py`)
  limits/<cell>.json       the limit of each number the cell's comparison
                           with the reference computes
  metrics/<metric>.py      the reader of one per-layer metric: read(run) ->
                           a number, or None when the run has nothing to read

so a later change adds a configuration, a traffic mix or a metric as new
files and `BENCHMARK.json` entries, and edits none of these.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
import zlib
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# what no process of the benchmark may load, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "captra_tpu")


def process_age() -> float:
    """Seconds since this process started (its start time in clock ticks
    after boot, against the uptime), 0 where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Clock:
    """Seconds since the process started: its age when this was made plus
    the perf counter's time since then."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.age0 = process_age()

    def since_start(self) -> float:
        return self.age0 + time.perf_counter() - self.t0


def derive_seed(seed: int, tag: str) -> int:
    """A generator seed for one use (`tag`) of the run's seed."""
    return (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(tag.encode())) \
        % (2 ** 63)


def load_spec(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of `BENCHMARK.json` with its files read."""
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    bench_dir: str = BENCH_DIR


def _applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def find_cell(spec: dict, name: str, root: str = ROOT) -> Cell:
    """The workload `name` of `spec` with its configuration, traffic and
    limits read from their files in the checkout at `root`, and the metrics
    it reports."""
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(work)})")
    w = work[name]

    def read(*parts):
        with open(os.path.join(bench_dir, *parts)) as f:
            return json.load(f)

    cfg_file = {c["name"]: c["file"] for c in spec["configs"]}[w["config"]]
    config = read(os.path.relpath(os.path.join(root, cfg_file), bench_dir))
    traffic = read("traffic", f"{w['traffic']}.json")
    limits_path = os.path.join(bench_dir, "limits", f"{name}.json")
    limits = {}
    if os.path.exists(limits_path):
        limits = read("limits", f"{name}.json")["limits"]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                traffic_name=w["traffic"], config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layer,
                bench_dir=bench_dir)


def _load_file(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The `read(run)` function of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    safe = "".join(c if c.isalnum() else "_" for c in name)
    return _load_file(path, f"port_bench_metric_{safe}").read


def driver(name: str):
    """The module drivers/<name>.py: its `run(ctx)` measures a cell."""
    return importlib.import_module(f"port_bench.drivers.{name}")


def reference(name: str):
    """The plain reference reference/<name>.py."""
    return importlib.import_module(f"port_bench.reference.{name}")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


@dataclass
class Context:
    """What a driver needs to measure a cell."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    clock: Clock
    log: object = print


@dataclass
class Outcome:
    """A driver's result: the values it measured (end to end, and for the
    per-layer readers `run`), the comparison's numbers, and the device
    readings."""
    attempted: int
    failed: int
    values: dict
    checks: dict
    device: dict
    run: object = None
    breakdown: dict | None = None


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Each number compared beside its limit; correct when every number has
    a limit and is within it (a NaN is never within)."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        good = limit is not None and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok and bool(checks), out


def result(cell: Cell, outcome: Outcome, trace: bool) -> tuple[dict, list]:
    """The result line's object and the stderr lines of the checks."""
    correct, checks = judge(outcome.checks, cell.limits)
    correct = correct and outcome.failed == 0
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        if trace:
            value = metric_reader(m["name"], cell.bench_dir)(outcome.run)
        else:
            value = outcome.values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics,
            "device": outcome.device}
    if trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    line["checks"] = checks
    lines = [f"check {k}: {v['value']!r} limit {v['limit']!r}"
             for k, v in checks.items()]
    lines.append(f"check failed_frames: {outcome.failed} limit 0")
    return line, lines
