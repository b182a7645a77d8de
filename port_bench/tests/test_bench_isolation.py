"""What the benchmark's run loads holds no JAX and nothing of the JAX
package, and the plain reference loads nothing of the program (top-level
module names compared whole)."""
from __future__ import annotations

import json
import subprocess
import sys

from port_bench.harness import FORBIDDEN, ROOT

RUN_CELL = """
import json, sys
import torch
torch.set_num_threads(2)
import port_bench.run
from port_bench.drivers import track
from port_bench.harness import result
from port_bench.tests.conftest import cpu_context, tiny_cell
cell = tiny_cell("bottle_otf_b16")
result(cell, track.run(cpu_context(cell, seconds=0.5, trace=True)), True)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""

LOAD_REFERENCE = """
import json, sys
import port_bench.reference.captra
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    loaded = _top_level(RUN_CELL)
    assert "captra_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level(LOAD_REFERENCE)
    assert not loaded & ({"captra_tpu_torch"} | set(FORBIDDEN))
