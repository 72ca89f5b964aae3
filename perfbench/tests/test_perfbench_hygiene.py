"""What a run loads: no JAX, no JAX package (top-level names compared
whole: deepim_tpu_torch begins with deepim_tpu), none of the JAX-era
harnesses; the plain reference loads nothing of the program."""
from __future__ import annotations

import json
import subprocess
import sys

from perfbench import harness

RUN_TINY = """
import json, sys, time
sys.path.insert(0, {root!r})
from perfbench import harness
from perfbench.tests.tiny import tiny_cell
import perfbench.run, perfbench.control
for name in ("lm6d_ape.refine_b32",):
    c = tiny_cell(name)
    harness.driver(c).run(c, 3, 0.0, False, time.time(), device="cpu")
for m in sorted((harness.HERE / "metrics").glob("*.py")):
    harness.load_module(m)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.deepim, perfbench.reference.net, perfbench.reference.render
import perfbench.reference.zoom, perfbench.reference.geometry
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(harness.ROOT))], capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    mods = _modules(RUN_TINY)
    assert "deepim_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN), mods & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE_ONLY)
    assert not mods & ({"deepim_tpu_torch"} | set(harness.FORBIDDEN))


def test_no_file_reads_the_jax_era_records():
    for path in harness.HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in ("BENCH_r", "MULTICHIP_", "import __graft_entry__", "import bench", "bench.py", "import jax",
                     "from jax", "import deepim_tpu\n", "from deepim_tpu ", "from deepim_tpu."):
            assert word not in text, (path, word)
