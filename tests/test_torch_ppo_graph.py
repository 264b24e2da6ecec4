"""``make_ppo_update``'s rows collection as one CUDA graph
(``parallel/rollout.py`` ``_StepsGraph``), on the card: its updates equal,
bitwise, those of the eager loop rebuilt per call
(``testing.rebuilt_ppo_update``), with and without ``reset_every``; one
capture and a replay for every later call; a second model recaptures; what
a call returns is left as it was by the next call's replay; a traced
replay still names the rows kernel and records no step's host work; an env
on a card named by its index captures and replays there; and every
scenario whose PPO collection takes the graph matches the eager loop.

Every test needs a CUDA GPU (``gpu`` marker) and skips without one; the
file imports no JAX. On a machine with a card:

    python -m pytest --noconftest tests/test_torch_ppo_graph.py -q
"""

import pytest
import torch
from torch.autograd import DeviceType

from vmas_tpu_torch import make_env, profiling
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import tree_map
from vmas_tpu_torch.parallel import ppo as TP
from vmas_tpu_torch.parallel.rollout import _noisy, rows_rollout_supported
from vmas_tpu_torch.testing import ppo_updates, rebuilt_ppo_update, tensors_equal

pytestmark = pytest.mark.gpu

# transport.ppo's size: 16384 envs x 4 agents, horizon 128, 4 bf16 epochs
B, T, EPOCHS, UPDATES = 16384, 128, 4, 3


@pytest.fixture(autouse=True)
def card():
    """Skips without a card; each test starts from an empty span recorder
    that records only under a profiler session, and leaves it so."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the rows step's kernel has no CPU mode")
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


# every scenario (and configuration) whose PPO collection takes the graph:
# fused rows, no per-step noise, one shared actor-critic; between them they
# capture the PID controller's carry rows (give_way, multi_give_way,
# joint_passage's controller), unpack's read of the step's actions
# (dropout) and a decode_transform (football's two teams). No such scenario
# reads the comm state: the PPO helpers refuse communication.
GRAPHED = [("balance", {}), ("ball_passage", {}), ("ball_trajectory", {}), ("buzz_wire", {}), ("dispersion", {}),
           ("dropout", {}), ("football", {"ai_red_agents": False}), ("give_way", {}), ("joint_passage", {}),
           ("joint_passage", {"use_controller": True}), ("joint_passage_size", {}), ("multi_give_way", {}),
           ("passage", {}), ("reverse_transport", {}), ("simple", {}), ("simple_spread", {}), ("transport", {}),
           ("waterfall", {}), ("wheel", {})]


def _env(num_envs=B, device="cuda"):
    return make_env("transport", num_envs=num_envs, device=device, seed=0, n_agents=4, fused_physics=True)


def _model(env, seed=0):
    return TP.init_actor_critic(TP.obs_dim_of(env), 2, generator=torch.Generator(device=env.device).manual_seed(seed),
                                device=env.device)


def _both(env, horizon, reset_every=None, dtype=torch.bfloat16, epochs=EPOCHS):
    update, make_opt = TP.make_ppo_update(env, horizon=horizon, collect="rows", epochs=epochs,
                                          compute_dtype=dtype, reset_every=reset_every)
    return update, rebuilt_ppo_update(env, horizon, epochs, dtype, reset_every), make_opt


def _run(update, make_opt, env, n, seed, model_seed=0):
    model = _model(env, model_seed)
    return ppo_updates(update, model, make_opt(model), env.state, env.steps, n, seed)


def _counted(update, make_opt, env, n, seed, model_seed=0):
    """``_run`` with the span recorder on -> (its updates, the spans' summary)."""
    profiling.enable()
    try:
        got = _run(update, make_opt, env, n, seed, model_seed)
        return got, profiling.summary()
    finally:
        profiling.enable(False)
        profiling.reset()


@pytest.mark.parametrize("reset_every", [None, 32])
def test_graphed_updates_equal_the_eager_loop(reset_every):
    """3 updates at transport.ppo's size: every trajectory tensor (with
    the policy's raw samples and log-densities), the state, the losses and
    the parameters after each update bitwise the eager loop's; one capture
    (the first call's first chunk) and a replay for every later chunk; the
    capturing call's warm-up and capture ran the steps' host work, the
    replays none; the launch counter counts each replay's launches."""
    env = _env()
    update, eager, make_opt = _both(env, T, reset_every)
    chunk = reset_every or T
    profiling.enable()
    launches = F.rows_step_launches
    got = _run(update, make_opt, env, UPDATES, seed=7)
    torch.cuda.synchronize()
    assert F.rows_step_launches - launches == UPDATES * T
    s = profiling.summary()
    profiling.enable(False)
    assert s["vmas.rows.capture"]["count"] == 1
    assert s["vmas.rows.replay"]["count"] == UPDATES * T // chunk - 1
    assert s["vmas.rows.policy_step"]["count"] == 2 * chunk and s["vmas.rows.launch"]["count"] == 2 * chunk
    want = _run(eager, make_opt, env, UPDATES, seed=7)
    for k, (g, w) in enumerate(zip(got, want)):
        for part in ("traj", "state", "steps", "metrics", "params"):
            assert tensors_equal(g[part], w[part]), (k, part)
    assert not tensors_equal(got[0]["params"], got[-1]["params"])


def test_a_second_model_recaptures_and_matches_eager():
    """Another model's parameters lie elsewhere: its first update
    recaptures (a capture records in every run, so one a model), its second
    replays, and both equal the eager loop's. The first model and its
    optimizer stay alive, so the second's parameters cannot take their
    memory."""
    env = _env(4096)
    update, eager, make_opt = _both(env, 16)
    first = _model(env, 0)
    first_opt = make_opt(first)
    ppo_updates(update, first, first_opt, env.state, env.steps, 2, seed=3)
    profiling.enable()
    got = _run(update, make_opt, env, 2, seed=4, model_seed=1)
    s = profiling.summary()
    profiling.enable(False)
    assert s["vmas.rows.capture"]["count"] == 2 and s["vmas.rows.replay"]["count"] == 1
    want = _run(eager, make_opt, env, 2, seed=4, model_seed=1)
    for g, w in zip(got, want):
        assert tensors_equal(g, w)


def test_nothing_a_call_returns_aliases_the_graph():
    """The trajectory and state a replay returned are unchanged by the next
    replay (from another state, with other parameters)."""
    env = _env(4096)
    update, _, make_opt = _both(env, 16)
    model = _model(env)
    opt = make_opt(model)
    first, second = ppo_updates(update, model, opt, env.state, env.steps, 2, seed=5)
    snapshot = {k: tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, second[k])
                for k in ("traj", "state")}
    third, = ppo_updates(update, model, opt, second["state"], second["steps"], 1, seed=6)
    torch.cuda.synchronize()
    for k in ("traj", "state"):
        assert tensors_equal(second[k], snapshot[k]), k
    assert not tensors_equal(second["traj"], third["traj"])


def test_a_traced_replay_names_the_kernel_and_records_no_step():
    """Under the profiler a replayed update's device records hold the rows
    kernel once a step and no span; its host records hold the replay and no
    policy step or launch."""
    env = _env(1024)
    update, _, make_opt = _both(env, 8)
    model = _model(env)
    opt = make_opt(model)
    out, = ppo_updates(update, model, opt, env.state, env.steps, 1, seed=2)  # the capture
    torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ppo_updates(update, model, opt, out["state"], out["steps"], 1, seed=3)
        torch.cuda.synchronize()
    device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert sum("fused_step_kernel" in n for n in device) == 8
    assert not [n for n in device if "vmas." in n]
    host = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    assert "vmas.rows.replay" in host and "vmas.rows.capture" not in host
    assert "vmas.rows.policy_step" not in host and "vmas.rows.launch" not in host


@pytest.mark.parametrize("index", [0, 1])
def test_an_env_on_a_named_card_captures_there(index):
    """An env on ``cuda:<index>``, with card 0 the current one: the capture
    and the replays run on the env's card, so 3 updates equal the eager
    loop's bitwise, with one capture and two replays. Index 1 needs a second
    card, and is the case where the env's card is not the current one."""
    if index >= torch.cuda.device_count():
        pytest.skip(f"needs {index + 1} CUDA devices")
    torch.cuda.set_device(0)
    env = _env(1024, device=f"cuda:{index}")
    update, eager, make_opt = _both(env, 8)
    got, s = _counted(update, make_opt, env, 3, seed=9)
    assert s["vmas.rows.capture"]["count"] == 1 and s["vmas.rows.replay"]["count"] == 2
    assert torch.cuda.current_device() == 0
    want = _run(eager, make_opt, env, 3, seed=9)
    for k, (g, w) in enumerate(zip(got, want)):
        assert tensors_equal(g, w), k
    assert got[-1]["traj"]["rewards"].device == torch.device(f"cuda:{index}")


@pytest.mark.parametrize("scenario,kw", GRAPHED, ids=[n + "".join(f",{k}={v}" for k, v in kw.items())
                                                      for n, kw in GRAPHED])
def test_every_graphed_scenario_equals_the_eager_loop(scenario, kw):
    """Each scenario whose collection takes the graph, at 256 envs,
    horizon 8, in float32: 2 graphed updates (one capture, one replay)
    equal, bitwise, 2 of the eager loop rebuilt per call."""
    env = make_env(scenario, num_envs=256, device="cuda", seed=0, fused_physics=True, **kw)
    assert rows_rollout_supported(env) and not _noisy(env)
    update, eager, make_opt = _both(env, 8, dtype=None, epochs=1)
    got, s = _counted(update, make_opt, env, 2, seed=13)
    assert s["vmas.rows.capture"]["count"] == 1 and s["vmas.rows.replay"]["count"] == 1
    want = _run(eager, make_opt, env, 2, seed=13)
    for k, (g, w) in enumerate(zip(got, want)):
        for part in ("traj", "state", "steps", "metrics", "params"):
            assert tensors_equal(g[part], w[part]), (k, part)
