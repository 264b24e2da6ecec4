"""The ``navigation`` configuration and its rollout cell
(``navigation.rollout``): the plain reference,
its Lidar included, against the port on the CPU at a tiny size; the
reference Lidar against hand-built cases of VMAS's definition; the check's
control, the planted faults and a planted Lidar fault coming out as not
correct; the counts behind the K2 and Lidar shares.

Run from the repository's root: ``python -m pytest portbench -q``.
"""

import json
import math
import time
from pathlib import Path

import pytest
import torch

from portbench import counts as C
from portbench import faults
from portbench import harness as H
from portbench import lidar_counts as L
from portbench import lidar_fault, run
from portbench.reference import physics as P

ROOT = Path(__file__).resolve().parents[1]
CELLS = ["navigation.rollout"]
SEED = 2**31 + 17
NAV = H.load_module(ROOT / "portbench" / "configs" / "navigation.py", "test_cfg_navigation")


def tiny_cell(name, B=8):
    cell = H.load_cell(name, ROOT)
    cell.num_envs = B
    cell.traffic.update(horizon=5, warm_calls=2)
    return cell


def run_cpu(cell, seed=SEED):
    return cell.runner.run(cell, seed, 0.3, False, "cpu", time.perf_counter())


def test_world_table_is_the_programs():
    """The reference's constants, worked out from the configuration's entity
    table, are the ones the port's kernel spec holds; its emit rows are
    the fused step's."""
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.core import fused as F

    env = make_env("navigation", num_envs=2, device="cpu", seed=0, fused_physics=True)
    ks, spec = F._kernel_spec(env.world), P.Spec(NAV.WORLD)
    assert [e.name for e in env.world.entities] == NAV.ENTITY_NAMES
    for key in ("E", "J", "substeps", "sub_dt", "cm", "cf", "jf", "tcf", "x_semidim", "y_semidim", "movable",
                "rotatable", "max_f", "f_range", "inv_mass", "inv_moi", "drag_fac", "joints", "ss", "ls", "ll",
                "bs", "bl", "bb", "trig"):
        assert getattr(spec, key) == getattr(ks, key), key
    fo = env._fused_outputs
    assert (fo.n_out, fo.carry_extra_idx, fo.unpack_reads) == (NAV.N_OUT, NAV.CARRY_EXTRA_IDX, ("state",))
    assert [a.index for a in env.agents] == NAV.ACT_SLOTS
    lidar = env.agents[0].sensors[0]
    assert (len(lidar._angles), lidar.max_range) == (NAV.N_RAYS, NAV.LIDAR_RANGE)
    assert torch.equal(torch.as_tensor(lidar._angles)[None], NAV._angles(torch.zeros(1)))


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program(name):
    """A whole run of the cell on the CPU at 8 envs: the program and the
    reference agree to the bit on every compared number (navigation's
    Lidar observations included: the same operations on the same values)."""
    res = run_cpu(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0.0 for c in res["checks"].values()), res["checks"]


def test_the_lidar_sees_the_other_agents_bitwise():
    """Navigation's first call at 64 envs: the rays hit other agents in many
    env-steps, and every observation, the Lidar's included, is the
    reference's to the bit."""
    from vmas_tpu_torch.parallel.rollout import rows_rollout_fn

    from portbench.reference.physics import Spec

    cell = tiny_cell("navigation.rollout", B=64)
    s_init, s_run = H.seeds(SEED)
    env, _ = H.make_program_env(cell, "cpu")
    init = NAV.initial_state(64, torch.Generator().manual_seed(s_init), "cpu")
    state = H.program_state(env, init)
    _, _, traj = rows_rollout_fn(env, horizon=5)(state, env.steps, torch.Generator().manual_seed(s_run))
    _, (obs, _, _) = cell.runner._reference_call(cell, Spec(NAV.WORLD), cell.runner._leaves(state), s_run, 0)
    hits = sum(int((o[..., NAV.OBS_W:] > 0).sum()) for o in obs)
    assert hits >= 20, hits
    for got, want in zip(traj["obs"], obs):
        assert got.shape[-1] == NAV.OBS_W + NAV.N_RAYS and torch.equal(got, want)


def _one_agent_lidar(others, heading=0.0):
    """Agent 0's 12 distances at the origin with heading ``heading``, the
    other three agents at ``others``."""
    xs = [0.0] + [p[0] for p in others]
    ys = [0.0] + [p[1] for p in others]
    E = len(NAV.ENTITY_NAMES)
    px = [torch.zeros(1) for _ in range(E)]
    py = [torch.zeros(1) for _ in range(E)]
    rot = [torch.zeros(1) for _ in range(E)]
    for i, a in enumerate(NAV.ACT_SLOTS):
        px[a], py[a] = torch.tensor([xs[i]]), torch.tensor([ys[i]])
    rot[NAV.ACT_SLOTS[0]] = torch.tensor([heading])
    return NAV.lidar(px, py, rot)[0][0]


FAR = [(5.0, 5.0), (-5.0, 5.0)]


def test_the_reference_lidar_on_hand_built_cases():
    """VMAS's definition: a ray that meets a sphere head on reads the centre's
    distance minus the radius; a ray that misses, or meets a sphere behind
    it or beyond the range, reads the range; the fan turns with the heading
    (ray k at 2 pi k / 12 plus the heading)."""
    rng, hit = NAV.LIDAR_RANGE, 0.25 - NAV.AGENT_RADIUS
    ahead = _one_agent_lidar([(0.25, 0.0)] + FAR)
    assert ahead[0] == pytest.approx(hit, abs=1e-6)
    assert torch.all(ahead[1:] == rng)  # the next rays pass 0.125 from the centre
    behind = _one_agent_lidar([(-0.25, 0.0)] + FAR)
    assert behind[0] == rng and behind[6] == pytest.approx(hit, abs=1e-6)
    assert torch.all(_one_agent_lidar([(0.5, 0.0)] + FAR) == rng)  # 0.4 away, beyond the range
    # at 45 degrees between rays 1 and 2, whose lines pass 0.106 from its centre
    assert torch.all(_one_agent_lidar([(0.3, 0.3)] + FAR) == rng)
    turned = _one_agent_lidar([(0.0, 0.25), (0.25, 0.0), FAR[0]], heading=math.pi / 2)
    assert turned[0] == pytest.approx(hit, abs=1e-6) and turned[9] == pytest.approx(hit, abs=1e-6)
    assert int((turned < rng).sum()) == 2


def test_a_planted_lidar_fault_is_not_correct():
    """The program's rays not turned by the heading: ``obs_gap`` reads more
    than a decade over its limit, the other numbers stay exact."""
    cell = tiny_cell("navigation.rollout")
    with lidar_fault.planted():
        res = run_cpu(cell)
    checks = res["checks"]
    assert not res["correct"]
    assert checks["obs_gap"]["value"] > 10 * checks["obs_gap"]["limit"], checks
    assert all(checks[k]["value"] == 0.0 for k in ("rew_gap", "state_gap", "done_flips")), checks


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in the next lower precision, put in the program's
    place, fails one of the cell's numbers."""
    cell = tiny_cell(name)
    checks, ok = H.checks_of(cell.runner.control(cell, 5, "cpu"), cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("kind", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, kind, capsys, monkeypatch):
    """A whole run past the harness's look for a chip, with the timed path
    broken underneath: its result line says ``correct`` false."""
    monkeypatch.setattr(H, "forbidden_modules", lambda: [])
    cell = tiny_cell(name)
    args = run.parse(["--workload", name, "--seed", str(2**31 + 29), "--seconds", "0.3", "--trace", "0"])
    with faults.planted(kind, cell):
        assert run.run_cell(cell, args, "cpu", time.perf_counter()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]


def test_navigation_k2_counts_agree_with_the_chip_script():
    import chip_smoke
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.core import fused as F

    B = 8
    env = make_env("navigation", num_envs=B, device="cpu", seed=3, fused_physics=True)
    fo, ks = env._fused_outputs, F._kernel_spec(env.world)
    rows = F.pack_carry(env.world, env.state, fo)
    bound_s, _, ops, nbytes = C.k2_bound(NAV, rows, B)
    assert ops == chip_smoke.kernel_ops(ks, rows, fo, rows_form=True)
    assert nbytes == (2 * F.rows_layout(env.world, fo) + 2 * len(NAV.ACT_SLOTS) + fo.n_out) * B * 4


def test_lidar_counts():
    """A navigation call's counted Lidar work: at 4096 envs and 100 steps,
    59M ray-sphere tests (~1.5 GFLOP, the least work) bind on their 98 MB."""
    casts = 4096 * 100 * NAV.N_AGENTS
    rays, tests = casts * NAV.N_RAYS, casts * NAV.N_RAYS * (NAV.N_AGENTS - 1)
    ops, nbytes = L.lidar_work(casts, rays, tests)
    pairs = casts * (NAV.N_AGENTS - 1)
    assert ops == tests * L.SPHERE_TEST_OPS + pairs * L.SPHERE_PAIR_OPS + rays * L.RAY_OPS
    assert nbytes == 409_600 * (4 * 3 + 48) * 4
    bound_s, by = L.lidar_bound(casts, rays, tests)
    assert by == "bytes" and bound_s == nbytes / C.PEAK_BYTES
    counted = {"vmas.sensors.lidar.casts": casts, "vmas.sensors.lidar.rays": rays,
               "vmas.sensors.lidar.tests.sphere": tests}
    assert L.counted_bound(counted) == bound_s
    # a test of a shape without a count, or no test at all, has no bound
    assert L.counted_bound({**counted, "vmas.sensors.lidar.tests.box": rays}) is None
    assert L.counted_bound({**counted, "vmas.sensors.lidar.tests.sphere": 0}) is None


def test_lidar_metrics_read_the_programs_counters(monkeypatch):
    """The Lidar's readers divide what the spans and counters recorded, and
    read nothing where the program recorded nothing (a program without
    counters, or a CPU run with no device clock)."""
    from vmas_tpu_torch import profiling

    from portbench import spans

    cell = H.load_cell("navigation.rollout", ROOT)
    metrics = {m["name"]: m for m in cell.per_layer}
    names = ("lidar_ms.rollout", "states_ms.rollout", "lidar_roofline.rollout", "mfu_lidar.rollout")
    assert all(H.read_metric(cell, metrics[n], {"kind": "rollout"}) is None for n in names)
    fake = {"vmas.sensors.lidar": {"count": 8, "device_ms": [2.0] * 8},
            "vmas.rows.call": {"count": 2, "samples_ms": [20.0, 20.0]},
            "vmas.rows.states": {"count": 2, "device_ms": [18.0, 19.0]},
            "vmas.rows.launch": {"count": 20, "samples_ms": [0.02] * 20}}
    monkeypatch.setattr(spans, "summary_of", lambda name: fake.get(name))
    counted = {"vmas.sensors.lidar.casts": 10, "vmas.sensors.lidar.rays": 120, "vmas.sensors.lidar.tests.sphere": 360}
    monkeypatch.setattr(profiling, "counters", lambda: counted)
    r = {"kind": "rollout"}
    assert H.read_metric(cell, metrics["lidar_ms.rollout"], r) == 8.0
    assert H.read_metric(cell, metrics["states_ms.rollout"], r) == 18.5
    want = 100 * L.lidar_bound(10, 120, 360)[0] / 16e-3
    assert H.read_metric(cell, metrics["lidar_roofline.rollout"], r) == pytest.approx(want)
    # the whole step: K2's bound a step and the Lidar's (its counted bound
    # over the 20 launches) over the untraced stretch
    stretch = {"kind": "rollout", "steps": 20, "k2_bound_s": 1e-6, "stretch_s": 0.05}
    want = 100 * 20 * (1e-6 + L.lidar_bound(10, 120, 360)[0] / 20) / 0.05
    assert H.read_metric(cell, metrics["mfu_lidar.rollout"], stretch) == pytest.approx(want)
    counted["vmas.sensors.lidar.tests.line"] = 120
    assert H.read_metric(cell, metrics["lidar_roofline.rollout"], r) is None
    assert H.read_metric(cell, metrics["mfu_lidar.rollout"], stretch) is None
    monkeypatch.delattr(profiling, "counters")
    assert H.read_metric(cell, metrics["lidar_roofline.rollout"], r) is None
    assert H.read_metric(cell, metrics["mfu_lidar.rollout"], stretch) is None


def test_the_new_files_load_nothing_of_the_port_and_a_run_no_jax():
    """The configuration's reference, the Lidar's counts and fault module
    load nothing of the port; a CPU run of each new cell at 8 envs, with its
    metrics read, loads no JAX (in a fresh interpreter)."""
    from portbench.test_portbench_imports import top_level_modules

    mods = top_level_modules(
        "from pathlib import Path\n"
        "import portbench.lidar_counts, portbench.lidar_fault\n"
        "from portbench.harness import load_module\n"
        "load_module(Path('portbench/configs/navigation.py'), 'cfg_navigation')\n")
    assert not mods & {"jax", "jaxlib", "flax", "vmas_tpu", "vmas_tpu_torch"}, mods
    mods = top_level_modules(
        "import time\n"
        "from pathlib import Path\n"
        "from portbench import harness as H\n"
        "for name in ('navigation.rollout',):\n"
        "    cell = H.load_cell(name, Path('.'))\n"
        "    cell.num_envs = 8\n"
        "    cell.traffic.update(horizon=4)\n"
        "    cell.runner.run(cell, 1, 0.1, False, 'cpu', time.perf_counter())\n"
        "    [H.read_metric(cell, m, {'kind': 'rollout'}) for m in cell.per_layer]\n")
    assert "vmas_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "vmas_tpu"}, mods
