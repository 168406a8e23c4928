"""Nothing the benchmark loads is JAX or the JAX package: a fresh
process imports the harness, every runner, reader and the reference,
runs a tiny cell on the CPU, and holds no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``repro``; the reference alone loads
nothing of the port either."""

import subprocess
import sys

from conftest import ROOT

PRELUDE = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
"""


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code + """
print(sorted({m.split('.')[0] for m in sys.modules}))
"""], capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    top = _modules_after("""
import time
sys.path.insert(0, %r)
import portbench.run, portbench.control
from portbench import harness
from conftest import tiny_cell, tiny_train_cell
for m in harness.load_bench()["end_to_end"] + \\
        harness.load_bench()["per_layer"]:
    harness.reader(m["name"])
harness.run_cell(tiny_cell("fenix-cnn.device.iscx"), 3, 0.1, False, "cpu",
                 time.perf_counter())
harness.run_cell(tiny_train_cell(), 3, 0.1, False, "cpu",
                 time.perf_counter())
""" % str(ROOT / "portbench" / "tests"))
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    top = _modules_after("""
from portbench.reference import fenix_ref, model_ref, train_ref
from portbench import check, check_train
""")
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert "repro" not in path.read_text(), path
