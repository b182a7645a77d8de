"""Card-only: one short run of each cell through `run.py` on the card, its
result line as the contract asks (skips without a card)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from port_bench.harness import ROOT, find_cell, load_spec
from port_bench.tests.conftest import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS + ("bottle_coordnet_train_b12",))
def test_short_run_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    cell = find_cell(load_spec(), name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(line)[-1] == "checks"
