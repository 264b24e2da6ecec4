"""The port's fused kernel takes every world the JAX package fuses within its
caps, checks the caps that remain when an Environment is built, and runs a
world for which ``supports()`` is False on the plain physics, as the JAX
package does.

* simple_spread with 17 and 30 agents (34 and 60 entities, once beyond
  the 32-entity cap) runs fused in the port, and one env step on the fused
  step (K1's plain version) and on the plain path matches the JAX
  package's, evaluated op by op (``jax.disable_jit``: its jitted step at
  30 agents takes minutes to compile);
* balance with 17 agents and simple_tag with 6 good agents and 12
  adversaries (once beyond the 16-agent cap of the emits) build their
  kernel parameters when the Environment is built, and their fused step
  matches their plain path;
* a world beyond a cap that remains (MAX_E entities, MAX_A policy agents,
  MAX_K scratch rows), one the JAX package fuses, raises at construction,
  naming the cap;
* a world for which supports() is False (a pile of boxes over 10
  substeps, with more than MAX_E entities) runs unfused, as in the JAX
  package, and never builds its fused outputs;
* the per-entity constants, moved from the by-value spec into the table
  buffer, decode to the spec's values; the rule that takes one thread per
  env where a block of the group form would not fit the card's shared
  memory.

Tolerances: state rows atol 1e-5 rtol 1e-5; observations atol 2e-5 rtol
1e-5; rewards atol 2e-3; dones equal; the port's fused step against its own
plain path atol 1e-5 (the same terms, another order of the pair sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmas_tpu
import vmas_tpu.core as JC
import vmas_tpu_torch.core as TC
from vmas_tpu.core import fused as JF
from vmas_tpu.scenarios import load as jax_load
from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.environment import Environment
from vmas_tpu_torch.interop import state_from_numpy
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.testing import balance_contact_state, mpe_family_state, mpe_state

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
WIDE = (17, 30)


def _jax_env(name, **kw):
    with jax.disable_jit():
        return vmas_tpu.make_env(name, B, seed=0, **kw)


def _jax_world(name, **kw):
    """The JAX package's world of a scenario, built without an env."""
    return jax_load(name).Scenario().env_make_world(B, None, **kw)


@pytest.fixture(scope="module")
def wide():
    """Per agent count: the port's fused env, a state with overlapping
    agents, actions, and the JAX package's env.step from that state (op by
    op): (env, arrays, acts, (state, obs, rews, dones))."""
    out = {}
    for n in WIDE:
        env = torch_make_env("simple_spread", B, device="cpu", seed=0, fused_physics=True, n_agents=n)
        rng = np.random.default_rng(n)
        arrays = mpe_state(env, rng)
        acts = [rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32) for _ in env.agents]
        jenv = _jax_env("simple_spread", n_agents=n)
        kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
        jenv.state = jenv.state.replace(**kw, u=tuple(jnp.asarray(x) for x in arrays["u"]))
        with jax.disable_jit():
            obs, rews, dones, _ = jenv.step([jnp.asarray(a) for a in acts])
        out[n] = (env, arrays, acts, (jenv.state, obs, rews, dones), jenv.world)
    return out


@pytest.mark.parametrize("n", WIDE)
def test_wide_world_fuses(n, wide):
    """simple_spread with n agents fuses in the port as in the JAX package:
    2n entities within MAX_E, the kernel's emit parameters built when the
    env was; at 17 agents its rows fit a block of 8 lanes per env, at 30 the
    3661 emit rows do not, so it runs one thread per env."""
    env, jw = wide[n][0], wide[n][4]
    assert env.world.fused and env._fused_outputs is not None
    assert TF.supports(env.world) and JF.supports(jw)
    assert len(env.world.entities) == 2 * n <= K.MAX_E and n <= K.MAX_A
    fo = env._fused_outputs
    assert fo._kernel_emit is not None and fo.kernel_emit()[1].simple_spread.n_agents == n
    ks = TF._kernel_spec(env.world)
    need = TF.group_smem_bytes(ks, True, fo.n_scratch_in, 0, fo.n_out, n, 8)
    assert ks.lanes == (8 if need <= TF.SMEM_OPTIN else 1) == (8 if n == 17 else 1)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n", WIDE)
def test_wide_env_step_matches_jax(n, fused, wide):
    """One env step of simple_spread with n agents from a state with
    overlapping agents, on the fused step or the plain path, against the
    JAX package's: state, observations, rewards, dones."""
    _, arrays, acts, (j_state, j_obs, j_rews, j_dones), _ = wide[n]
    env = torch_make_env("simple_spread", B, device="cpu", seed=0, fused_physics=fused, n_agents=n)
    assert (env._fused_outputs is not None) == fused
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, _ = env.step([torch.as_tensor(a) for a in acts])
    for field in FIELDS:
        np.testing.assert_allclose(getattr(env.state, field).numpy(), np.asarray(getattr(j_state, field)),
                                   **STATE_TOL, err_msg=field)
    for i in range(n):
        np.testing.assert_allclose(obs[i].numpy(), np.asarray(j_obs[i]), atol=2e-5, rtol=1e-5, err_msg="obs")
        np.testing.assert_allclose(rews[i].numpy(), np.asarray(j_rews[i]), atol=2e-3, rtol=0, err_msg="reward")
    np.testing.assert_array_equal(dones.numpy(), np.asarray(j_dones))
    # the agents touched: contacts acted in the step
    assert TF.contact_counts(env.world, TF.state_rows(state_from_numpy(env.world, arrays)))["ss"] > 0


MANY_AGENTS = {
    "balance,17": ("balance", {"n_agents": 17}, balance_contact_state, "balance"),
    "simple_tag,6+12": ("simple_tag", {"num_good_agents": 6, "num_adversaries": 12}, mpe_family_state,
                        "simple_tag"),
}


@pytest.mark.parametrize("config", sorted(MANY_AGENTS))
def test_many_agent_emits_build_at_construction(config):
    """balance with 17 agents and simple_tag with 18 (beyond the emits' old
    16-agent cap, fused by the JAX package) build their kernel parameters
    when the Environment is built (each agent in its table), and their
    fused step matches their plain path on a state with contacts."""
    name, kw, make_state, member = MANY_AGENTS[config]
    env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=True, **kw)
    fo = env._fused_outputs
    assert fo._kernel_emit is not None, "the kernel parameters were not built at construction"
    p = getattr(fo._kernel_emit[1], member)
    agents = [a.index for a in env.world.policy_agents]
    assert p.n_agents == len(agents) > 16
    if name == "balance":
        assert [p.agent[i] for i in range(len(agents))] == agents
    else:
        assert p.a0 == agents[0] and [p.adversary[i] for i in range(len(agents))] == [1] * 12 + [0] * 6
    assert JF.supports(_jax_world(name, **kw))
    arrays = make_state(env, np.random.default_rng(5))
    rng = np.random.default_rng(6)
    acts = [rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32) for _ in env.agents]
    envs = [env, torch_make_env(name, B, device="cpu", seed=0, fused_physics=False, **kw)]
    outs = []
    for e in envs:
        e.state = state_from_numpy(e.world, arrays)
        outs.append(e.step([torch.as_tensor(a) for a in acts]))
    for field in FIELDS:
        torch.testing.assert_close(getattr(envs[0].state, field), getattr(envs[1].state, field), **STATE_TOL)
    for (of, op) in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(of, op, atol=2e-5, rtol=1e-5)
    for (rf, rp) in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(rf, rp, atol=2e-3, rtol=0)
    assert torch.equal(outs[0][2], outs[1][2])


@pytest.mark.parametrize("name,kw,cap", [
    ("simple_spread", {"n_agents": 33}, "MAX_E"),
    ("dispersion", {"n_agents": 33, "n_food": 4}, "MAX_A"),
    ("dispersion", {"n_agents": 4, "n_food": 9}, "MAX_K"),
])
def test_caps_raise_at_construction(name, kw, cap):
    """A world beyond a cap that remains, and that the JAX package fuses,
    raises NotImplementedError naming the cap when the Environment is built
    (never first at a launch on the card); the same world builds unfused."""
    assert JF.supports(_jax_world(name, **kw))
    with pytest.raises(NotImplementedError, match=cap):
        torch_make_env(name, B, device="cpu", seed=0, fused_physics=True, **kw)
    env = torch_make_env(name, B, device="cpu", seed=0, **kw)
    assert not env.world.fused and env._fused_outputs is None


def _box_pile(core, batch_dim, device=None):
    """8 box agents over 10 substeps (28 box-box pairs, a cost of 4480 in the
    JAX package's rule: beyond its limit of 4000) and 60 small landmarks
    that do not collide: 68 entities, more than MAX_E."""
    w = core.World(batch_dim, device, substeps=10)
    for i in range(8):
        w.add_agent(core.Agent(name=f"b{i}", shape=core.Box(0.2, 0.1), mass=2))
    for i in range(60):
        w.add_landmark(core.Landmark(name=f"m{i}", shape=core.Sphere(0.01), collide=False))
    w.finalize()
    return w


class _BoxPile(BaseScenario):
    def make_world(self, batch_dim, device=None, **kwargs):
        return _box_pile(TC, batch_dim, device)

    def reset_world_at(self, state, generator):
        pos = torch.rand(state.pos.shape, generator=generator, device=state.device) * 0.6 - 0.3
        return state.replace(pos=pos)

    def observation(self, agent, state):
        return agent.pos(state)

    def reward(self, agent, state):
        return state.pos[:, agent.index, 0]

    def make_fused_outputs(self, world):
        raise AssertionError("a world that does not fuse builds no fused outputs")


def test_unsupported_world_runs_unfused():
    """A world for which supports() is False in both packages (the box pile,
    68 entities) builds with fused_physics=True without raising, as in the
    JAX package, builds no fused outputs, and its steps are the plain
    physics' bitwise."""
    assert not JF.supports(_box_pile(JC, B)) and not TF.supports(_box_pile(TC, B, "cpu"))
    envs = [Environment(_BoxPile(), num_envs=B, device="cpu", seed=1, fused_physics=f) for f in (True, False)]
    assert envs[0].world.fused and envs[0]._fused_outputs is None
    assert len(envs[0].world.entities) == 68 > K.MAX_E
    g = torch.Generator().manual_seed(2)
    for _ in range(2):
        acts = [torch.rand((B, 2), generator=g) * 2 - 1 for _ in envs[0].agents]
        for env in envs:
            env.step(acts)
    for field in FIELDS:
        assert torch.equal(getattr(envs[0].state, field), getattr(envs[1].state, field)), field
    boxes = [a.index for a in envs[0].agents]
    assert bool(envs[0].state.vel[:, boxes].any())


@pytest.mark.parametrize("name", ["transport", "balance", "passage", "waterfall", "wind_flocking"])
def test_entity_constants_in_table(name):
    """The per-entity constants the kernel reads from the table buffer (one
    block of E words per field, from FusedSpec.o_ent) decode to the
    KernelSpec's values rounded once to f32: the flags, masses, clamps,
    friction, gravity (dynamic too) and drag; the by-value spec keeps the
    world's scalars and the action slots only."""
    env = torch_make_env(name, 2, device="cpu", seed=0, fused_physics=True)
    ks = TF._kernel_spec(env.world)
    fo = env._fused_outputs
    spec = ks.to_ctypes(int(fo.n_scratch_in) if fo is not None else 0)
    assert spec.o_ent == ks.ent_offset and spec.n_tab == ks.table.size == ks.ent_offset + 16 * ks.E
    assert spec.o_lst == ks.table_offsets[-1]
    block = ks.table[ks.ent_offset:].reshape(len(K.ENT_FIELDS), ks.E)
    for e in range(ks.E):
        want = ks._entity_fields(e)
        assert int(block[0, e]) == want[0]
        got = block[1:, e].view(np.float32)
        np.testing.assert_array_equal(got, np.asarray(want[1:], np.float32), err_msg=f"entity {e}")
    flags = block[0]
    assert bool((flags & K.F_MOVABLE).any())
    assert not any(f[0] in ("flags", "inv_mass", "mass") for f in K.FusedSpec._fields_)


@pytest.mark.parametrize("name,kw,lanes", [
    ("simple_spread", {"n_agents": 30}, 1),
    ("simple_spread", {"n_agents": 17}, 8),
    ("passage", {}, 8),
    ("joint_passage", {}, 8),
    ("simple_spread", {}, 1),
])
def test_lanes_fit_shared_memory(name, kw, lanes):
    """The lane rule and its shared-memory fit: 8 lanes per env where a type
    has more than 3 items, unless a block of 8 lanes would need more than
    SMEM_OPTIN bytes in either form (simple_spread at 30 agents: the 16
    envs' 3661 emit rows alone take 234 KB), then one thread per env."""
    env = torch_make_env(name, 2, device="cpu", seed=0, fused_physics=True, **kw)
    ks, fo = TF._kernel_spec(env.world), env._fused_outputs
    assert ks.lanes == lanes
    rows = TF.group_smem_bytes(ks, True, fo.n_scratch_in, fo.n_ctrl, fo.n_out + fo.n_ctrl_out, len(env.agents), 8)
    fused = TF.group_smem_bytes(ks, False, fo.n_scratch_in, 0, fo.n_out, 0, 8)
    fits = max(rows, fused) <= TF.SMEM_OPTIN
    assert (lanes == 8) == (TF.lanes_for(ks) == 8 and fits)
    # the output rows of a block's 16 envs are staged in shared memory
    assert fused > 4 * fo.n_out * 16
