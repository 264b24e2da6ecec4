"""The port stands alone: no module of vmas_tpu_torch, not chip_smoke.py and
no script under tools/ imports JAX, flax or anything of the JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "vmas_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "tools").glob("*.py"))
BANNED = ("jax", "jaxlib", "flax", "vmas_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None)) in (
            "import_module", "__import__"
        ) and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_files_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_parallel_imports_without_jax():
    """The port's rollouts, PPO and interop import nothing of JAX (a fresh
    interpreter: the test session itself has JAX loaded)."""
    code = ("import sys, vmas_tpu_torch.parallel, vmas_tpu_torch.parallel.ppo, vmas_tpu_torch.interop; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in " + repr(BANNED) + "))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(ROOT))
    assert out.stdout.strip() == "[]", out.stdout


def test_scenarios_import_without_jax():
    """Every ported scenario module, the MPE family's included, loads in a
    fresh interpreter without bringing in JAX or the JAX package."""
    code = ("import importlib, sys; scenarios = importlib.import_module('vmas_tpu_torch.scenarios'); "
            "[scenarios.load(n) for n in sorted(scenarios._PORTED)]; "
            "print(len(scenarios._PORTED), sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(BANNED) + "))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(ROOT))
    n, banned = out.stdout.strip().split(" ", 1)
    assert int(n) == 43 and banned == "[]", out.stdout


def test_football_modules_listed():
    """Football's modules (the scenario with its team AI, and the
    HolonomicWithRotation dynamics its shooting agents take) are among the
    files held to importing no JAX, and load without it."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"vmas_tpu_torch/scenarios/football.py", "vmas_tpu_torch/dynamics/holonomic_with_rot.py"} <= names
    code = ("import sys, vmas_tpu_torch.scenarios.football, vmas_tpu_torch.dynamics.holonomic_with_rot; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in " + repr(BANNED) + "))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(ROOT))
    assert out.stdout.strip() == "[]", out.stdout


def test_holonomic_worlds_and_heuristics_import_without_jax():
    """The other holonomic worlds (reverse_transport, wheel, passage,
    dispersion, dropout, het_mass), the heuristic policies of transport,
    balance and wheel and ``heuristic_policy`` load in a fresh interpreter
    without bringing in JAX or the JAX package."""
    mods = ["vmas_tpu_torch.scenarios." + n for n in ("reverse_transport", "wheel", "passage", "dispersion",
                                                       "dropout", "debug.het_mass", "transport", "balance")]
    code = ("import importlib, sys; mods = [importlib.import_module(m) for m in " + repr(mods) + "]; "
            "import vmas_tpu_torch.heuristic_policy as h; "
            "assert all(issubclass(m.HeuristicPolicy, h.BaseHeuristicPolicy) for m in mods if hasattr(m, "
            "'HeuristicPolicy')); "
            "print(sum(hasattr(m, 'HeuristicPolicy') for m in mods), sorted(m for m in sys.modules if "
            "m.split('.')[0] in " + repr(BANNED) + "))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(ROOT))
    assert out.stdout.strip() == "3 []", out.stdout


def test_sensor_worlds_import_without_jax():
    """Ray casting, the Lidar, the sensor worlds (navigation, flocking,
    discovery, pollock) and their heuristic policies load in a fresh
    interpreter without bringing in JAX or the JAX package."""
    mods = ["vmas_tpu_torch.core.raycast", "vmas_tpu_torch.sensors"] + [
        "vmas_tpu_torch.scenarios." + n for n in ("navigation", "flocking", "discovery", "debug.pollock")]
    code = ("import importlib, sys; mods = [importlib.import_module(m) for m in " + repr(mods) + "]; "
            "print(sum(hasattr(m, 'HeuristicPolicy') for m in mods), sorted(m for m in sys.modules if "
            "m.split('.')[0] in " + repr(BANNED) + "))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(ROOT))
    assert out.stdout.strip() == "3 []", out.stdout


def test_dynamics_models_and_debug_worlds_import_without_jax():
    """The five dynamics models ported with the debug worlds (static,
    rotation, forward, diff_drive, drone) and the seven dynamics and
    controller debug worlds are among the files held to importing no JAX,
    and load in a fresh interpreter without it."""
    models = ["static", "rotation", "forward", "diff_drive", "drone"]
    worlds = ["diff_drive", "kinematic_bicycle", "drone", "goal", "vel_control", "circle_trajectory",
              "line_trajectory"]
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"vmas_tpu_torch/dynamics/{m}.py" for m in models} <= names
    assert {f"vmas_tpu_torch/scenarios/debug/{w}.py" for w in worlds} <= names
    mods = [f"vmas_tpu_torch.dynamics.{m}" for m in models] + [f"vmas_tpu_torch.scenarios.debug.{w}" for w in worlds]
    code = ("import importlib, sys; [importlib.import_module(m) for m in " + repr(mods) + "]; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in " + repr(BANNED) + "))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(ROOT))
    assert out.stdout.strip() == "[]", out.stdout


def test_dots_worlds_and_wrappers_import_without_jax():
    """dots_core, painting, construction and sampling, the Wrapper enum and
    the gym, gymnasium and rllib wrappers are among the files held to
    importing no JAX, and load in a fresh interpreter without it."""
    files = ["dots_core.py", "scenarios/painting.py", "scenarios/construction.py", "scenarios/sampling.py",
             "environment/__init__.py", "environment/gym_wrappers.py", "environment/rllib.py"]
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"vmas_tpu_torch/{f}" for f in files} <= names
    mods = ["vmas_tpu_torch.dots_core", "vmas_tpu_torch.environment.gym_wrappers",
            "vmas_tpu_torch.environment.rllib"] + [
        f"vmas_tpu_torch.scenarios.{w}" for w in ("painting", "construction", "sampling")]
    code = ("import importlib, sys; [importlib.import_module(m) for m in " + repr(mods) + "]; "
            "from vmas_tpu_torch.environment import Wrapper; "
            "print(len(Wrapper), sorted(m for m in sys.modules if m.split('.')[0] in " + repr(BANNED) + "))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(ROOT))
    assert out.stdout.strip() == "4 []", out.stdout


def test_rendering_imports_without_jax():
    """The viewer, the drawing helpers, the video writer, interactive play
    and its module alias are among the files held to importing no JAX, and
    load in a fresh interpreter without it."""
    files = ["render/__init__.py", "render/draw.py", "render/viewer.py", "render/video.py",
             "render/interactive.py", "interactive_rendering.py"]
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"vmas_tpu_torch/{f}" for f in files} <= names
    mods = ["vmas_tpu_torch.render", "vmas_tpu_torch.render.draw", "vmas_tpu_torch.render.viewer",
            "vmas_tpu_torch.render.video", "vmas_tpu_torch.render.interactive",
            "vmas_tpu_torch.interactive_rendering"]
    code = ("import importlib, sys; [importlib.import_module(m) for m in " + repr(mods) + "]; "
            "from vmas_tpu_torch import render_interactively; "
            "print(callable(render_interactively), sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(BANNED) + "))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(ROOT))
    assert out.stdout.strip() == "True []", out.stdout


def test_package_needs_no_matplotlib():
    """With matplotlib unimportable (``sys.modules["matplotlib"] = None``),
    the package and the rendering modules import, transport builds on the
    CPU and steps, and ``env.render`` raises an ImportError that names
    matplotlib (as where it is not installed)."""
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "import vmas_tpu_torch, vmas_tpu_torch.render.viewer, vmas_tpu_torch.render.interactive\n"
        "import vmas_tpu_torch.interactive_rendering\n"
        "env = vmas_tpu_torch.make_env('transport', num_envs=2, device='cpu', seed=0)\n"
        "obs, rews, dones, infos = env.step(env.get_random_actions())\n"
        "try:\n"
        "    env.render(mode='rgb_array')\n"
        "except ImportError as e:\n"
        "    print('ImportError', 'matplotlib' in str(e), len(obs), tuple(rews[0].shape))\n"
        "else:\n"
        "    print('rendered')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(ROOT))
    assert out.stdout.strip() == "ImportError True 4 (2,)", out.stdout + out.stderr


def test_utilities_sharding_and_examples_import_without_jax():
    """checkpoint, debug, profiling, the mesh and the learner, the testing
    helpers' rank worker and every example are among the files held to
    importing no JAX, and load in a fresh interpreter without it."""
    files = ["checkpoint.py", "debug.py", "profiling.py", "parallel/mesh.py", "parallel/learner.py",
             "examples/__init__.py"] + [f"examples/{n}.py" for n in EXAMPLES]
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"vmas_tpu_torch/{f}" for f in files} <= names
    mods = ["vmas_tpu_torch.checkpoint", "vmas_tpu_torch.debug", "vmas_tpu_torch.profiling",
            "vmas_tpu_torch.parallel.mesh", "vmas_tpu_torch.parallel.learner", "vmas_tpu_torch.testing"] + [
        f"vmas_tpu_torch.examples.{n}" for n in EXAMPLES]
    code = ("import importlib, sys; [importlib.import_module(m) for m in " + repr(mods) + "]; "
            "import vmas_tpu_torch as v; from vmas_tpu_torch.parallel import distribute, env_mesh, shard_state; "
            "print(len(v.scenarios), len(v.debug_scenarios), len(v.mpe_scenarios), v.Wrapper.RLLIB.value, "
            "sorted(m for m in sys.modules if m.split('.')[0] in " + repr(BANNED) + "))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(ROOT))
    assert out.stdout.strip() == "23 11 9 3 []", out.stdout


EXAMPLES = ("use_vmas_tpu_env", "run_heuristic", "speed_sweep", "train_ppo", "train_sharded")
