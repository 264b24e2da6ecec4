"""No run loads JAX or the JAX package, and the plain reference loads
nothing of the port: checked in a fresh interpreter, which the repository's
root ``conftest.py`` (it imports JAX) cannot touch. Run from the
repository's root: ``python -m pytest portbench -q``."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def top_level_modules(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """The harness, every cell's configuration, runner and metrics, the
    reference, the faults and a whole CPU run of each cell at 8 envs."""
    mods = top_level_modules(
        "import time\n"
        "from pathlib import Path\n"
        "import portbench.run, portbench.calibrate, portbench.faults\n"
        "from portbench import harness as H\n"
        "for name in ('transport.ppo', 'joint_passage.rollout'):\n"
        "    cell = H.load_cell(name, Path('.'))\n"
        "    cell.num_envs = 8\n"
        "    cell.traffic.update(horizon=4, epochs=1)\n"
        "    cell.runner.run(cell, 1, 0.1, False, 'cpu', time.perf_counter())\n"
        "    [H.read_metric(cell, m, {}) for m in cell.per_layer]\n")
    assert "vmas_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "vmas_tpu"}, mods


def test_the_reference_loads_nothing_of_the_port():
    mods = top_level_modules(
        "from pathlib import Path\n"
        "import portbench.reference.physics, portbench.reference.rollout, portbench.reference.ppo\n"
        "import portbench.counts\n"
        "from portbench.harness import load_module\n"
        "for c in ('transport', 'joint_passage'):\n"
        "    load_module(Path('portbench/configs') / (c + '.py'), 'cfg_' + c)\n")
    assert not mods & {"jax", "jaxlib", "flax", "vmas_tpu", "vmas_tpu_torch"}, mods
