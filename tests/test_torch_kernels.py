"""The CUDA kernels (vmas_tpu_torch/csrc/fused_step.cu, road_traffic.cu,
opcost.cu) against their plain PyTorch versions, on the card.

The kernel has no CPU mode, so every test here needs a CUDA GPU: they carry
the ``gpu`` marker and skip without one. On a machine with a card and the
CUDA toolkit:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest`` keeps the repository's JAX test configuration out; these
tests import no JAX.) Tolerances as in chip_smoke.py: state rows atol 1e-5
rtol 1e-5, observation rows atol 2e-5, reward and shaping rows atol 2e-3;
road_traffic's path sweeps and observations: the sweep kernel's group
form and the observation kernel at every tile its rule picks bitwise their
one-thread forms; indices, flags, short-term points and chosen neighbours
equal to the plain version's, values atol 1e-6; its env with both
kernels against the plain path atol 5e-5; balance's on_ground and done flags
equal except within 1e-5 of a threshold; joint_passage's just_passed and
done flags likewise; give_way's and multi_give_way's rows step with the
in-kernel PID: controller rows and the controller's output atol 1e-5, the
goal flags equal; one launch of 4 env steps against 4 launches of one,
bitwise; wind_flocking's fused step with dynamic gravity and the MPE emits
(simple, simple_spread, simple_push, simple_adversary, simple_tag,
simple_reference, simple_speaker_listener, simple_world_comm) in both
forms bitwise, and simple_world_comm's rows rollout bitwise its env.step
rollout; the emits of reverse_transport, wheel, passage, dispersion,
dropout and het_mass in both forms bitwise, dropout's rows rollout
bitwise its env.step rollout, simple_spread with 17 and 30 agents
bitwise; the emits of buzz_wire, ball_trajectory, ball_passage and
joint_passage_size (with its PID in K2) in both forms bitwise, asym_joint's
K1 with no emit, and joint_passage_size's rows rollouts, noisy or not,
bitwise rollout_fn; the emits of navigation, flocking and discovery in
both forms bitwise, and navigation's and flocking's rows rollouts bitwise
rollout_fn; football's emit in both forms and its ball script in K2
bitwise, and its rows rollouts bitwise rollout_fn; K1 with no emit in the
seven dynamics and controller debug worlds (diff_drive, kinematic_bicycle,
drone, goal, vel_control, circle_trajectory, line_trajectory) and in
painting (nav and full), construction and sampling in both forms bitwise,
sampling's visited cells on the card bitwise the CPU's; road_traffic's
kernels on map 3's tables, map 2 and testing mode against their one-thread
forms and plain versions, with two sweeps a step in map 3 and testing
mode; the op-cost probe's ALU chain
bitwise, its transcendental chain atol 1e-6 rtol 1e-5. The balance,
all-pairs, joint_passage, waterfall, give_way, multi_give_way,
wind_flocking and MPE states come from vmas_tpu_torch/testing.py, as
chip_smoke.py's do.
"""

import pytest
import torch

from vmas_tpu_torch import make_env
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk

pytestmark = pytest.mark.gpu

# not a multiple of the kernel's 128-thread block, so the last block is ragged
B = 300


@pytest.fixture
def env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused-step kernel has no CPU mode")
    e = make_env("transport", B, device="cuda", seed=0, n_agents=4, fused_physics=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    st = e.state
    # agents jittered around the package so that contacts occur
    pkg = st.pos[:, e.scenario.packages[0].index]
    pos = st.pos.clone()
    for a in e.world.agents:
        pos[:, a.index] = pkg + torch.randn((B, 2), generator=g, device="cuda") * 0.08
    e.state = st.replace(pos=pos, vel=torch.randn(st.vel.shape, generator=g, device="cuda") * 0.1,
                         rot=torch.rand(st.rot.shape, generator=g, device="cuda") * 6.283)
    return e


def _close(got, want, atol, rtol=1e-5):
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def _check(env, got, want):
    E, fo = len(env.world.entities), env._fused_outputs
    r = 9 * E + fo.n_agents * fo.obs_w
    _close(got[:9 * E], want[:9 * E], 1e-5)
    _close(got[9 * E:r], want[9 * E:r], 2e-5)
    _close(got[r:], want[r:], 2e-3)


def test_fused_step_kernel_matches_plain(env):
    world, fo = env.world, env._fused_outputs
    x = F.pack_carry(world, env.state, fo)
    n = F.fused_step_launches
    y = F.fused_step(world, x, fo)
    torch.cuda.synchronize()
    assert F.fused_step_launches == n + 1
    _check(env, y, F.fused_step_plain(world, x, fo))


def test_rows_step_kernel_matches_plain(env):
    world, fo = env.world, env._fused_outputs
    slots = [a.index for a in env.agents]
    step = F.make_rows_step(world, fo, slots)
    carry = F.pack_carry(world, env.state, fo)
    g = torch.Generator(device="cuda").manual_seed(4)
    n = F.rows_step_launches
    for _ in range(5):
        act = (torch.rand((2 * len(slots), B), generator=g, device="cuda") * 2 - 1) * 0.6
        ck, ek = step(carry, act)
        cp, ep = F.rows_step_plain(world, fo, slots, carry, act)
        E = len(world.entities)
        _check(env, torch.cat([ck[:9 * E], ek]), torch.cat([cp[:9 * E], ep]))
        carry = ck
    torch.cuda.synchronize()
    assert F.rows_step_launches == n + 5


def test_wrapper_rejects_bad_input(env):
    world, fo = env.world, env._fused_outputs
    x = F.pack_carry(world, env.state, fo)
    with pytest.raises(ValueError, match="float32"):
        F.fused_step(world, x.double(), fo)
    with pytest.raises(ValueError, match="shape"):
        F.fused_step(world, x[1:], fo)
    with pytest.raises(ValueError, match="contiguous"):
        F.fused_step(world, x.t().contiguous().t(), fo)


def test_rows_rollout_on_the_card_equals_step_rollout(env):
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn

    s0, st0 = env.state, env.steps
    _, _, ta = rollout_fn(env, horizon=6)(s0, st0, torch.Generator(device="cuda").manual_seed(9))
    _, _, tb = rows_rollout_fn(env, horizon=6)(s0, st0, torch.Generator(device="cuda").manual_seed(9))
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(a, b) for a, b in zip(ta["obs"], tb["obs"]))


# -- balance and the all-pairs world: every contact pair type ------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused-step kernel has no CPU mode")


def test_balance_kernels_match_plain():
    import numpy as np

    from vmas_tpu_torch.testing import balance_contact_state, balance_flag_margin
    from vmas_tpu_torch.interop import state_from_numpy

    _cuda()
    e = make_env("balance", B, device="cuda", seed=0, fused_physics=True)
    world, fo = e.world, e._fused_outputs
    slots = [a.index for a in e.agents]
    E, base = len(world.entities), fo.base
    step = F.make_rows_step(world, fo, slots)
    carry = F.pack_carry(world, state_from_numpy(world, balance_contact_state(e, np.random.default_rng(5))), fo)
    g = torch.Generator(device="cuda").manual_seed(6)
    n1, n2 = F.fused_step_launches, F.rows_step_launches
    for _ in range(5):
        act = (torch.rand((2 * len(slots), B), generator=g, device="cuda") * 2 - 1) * 0.7
        ck, ek = step(carry, act)
        cp, ep = F.rows_step_plain(world, fo, slots, carry, act)
        yk, yp = F.fused_step(world, carry, fo), F.fused_step_plain(world, carry, fo)
        for (sk, xk), (sp, xp) in (((ck[:9 * E], ek), (cp[:9 * E], ep)), ((yk[:9 * E], yk[9 * E:]), (yp[:9 * E], yp[9 * E:]))):
            _close(sk, sp, 1e-5)
            _close(xk[:base], xp[:base], 2e-5)
            ok = (xk[base + 2:base + 4] == xp[base + 2:base + 4]).all(0)
            assert bool((ok | (balance_flag_margin(fo, sp) < 1e-5)).all())
            _close(xk[base:base + 2][:, ok], xp[base:base + 2][:, ok], 2e-3)
            _close(xk[base + 4], xp[base + 4], 2e-3)
        carry = ck
    torch.cuda.synchronize()
    assert (F.fused_step_launches, F.rows_step_launches) == (n1 + 5, n2 + 5)


def test_all_pairs_kernel_matches_plain():
    import numpy as np

    import vmas_tpu_torch.core as TC
    from vmas_tpu_torch.testing import all_pairs_state, all_pairs_world
    from vmas_tpu_torch.interop import state_from_numpy

    _cuda()
    w = all_pairs_world(TC, B, "cuda")
    s = state_from_numpy(w, all_pairs_state(np.random.default_rng(7), B))
    x = F.state_rows(s).contiguous()
    assert all(v > 0 for v in F.contact_counts(w, x).values())
    for _ in range(3):
        yk = F.fused_step(w, x)
        _close(yk, F.fused_step_plain(w, x), 1e-5)
        x = yk
    torch.cuda.synchronize()


# -- joints: joint_passage and waterfall ---------------------------------------

def _joint_env(name, build, seed):
    import numpy as np

    from vmas_tpu_torch.interop import state_from_numpy

    _cuda()
    e = make_env(name, B, device="cuda", seed=0, fused_physics=True)
    world, fo = e.world, e._fused_outputs
    slots = [a.index for a in e.agents]
    carry = F.pack_carry(world, state_from_numpy(world, build(e, np.random.default_rng(seed))), fo)
    return e, world, fo, slots, carry


def _both_forms(world, fo, slots, carry, act):
    """((state, emit) of K2, of its plain version, of K1, of its plain
    version) on one carry and action."""
    E = len(world.entities)
    ck, ek = F.make_rows_step(world, fo, slots)(carry, act)
    cp, ep = F.rows_step_plain(world, fo, slots, carry, act)
    x = carry.clone()
    x[6 * E + torch.as_tensor(slots, device="cuda")] = act[:len(slots)]
    x[7 * E + torch.as_tensor(slots, device="cuda")] = act[len(slots):]
    yk, yp = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
    return ck, [((ck[:9 * E], ek), (cp[:9 * E], ep)), ((yk[:9 * E], yk[9 * E:]), (yp[:9 * E], yp[9 * E:]))]


def test_joint_passage_kernels_match_plain():
    from vmas_tpu_torch.testing import joint_passage_contact_state, joint_passage_flag_margin

    e, world, fo, slots, carry = _joint_env("joint_passage", joint_passage_contact_state, 8)
    base = fo.base
    assert F.joint_counts(world, carry)["force"] > 0
    g = torch.Generator(device="cuda").manual_seed(9)
    n1, n2 = F.fused_step_launches, F.rows_step_launches
    for _ in range(3):
        act = (torch.rand((2 * len(slots), B), generator=g, device="cuda") * 2 - 1) * 0.8
        carry_k, pairs = _both_forms(world, fo, slots, carry, act)
        for (sk, xk), (sp, xp) in pairs:
            _close(sk, sp, 1e-5)
            _close(xk[:base], xp[:base], 2e-5)
            ok = (xk[base + 7:] == xp[base + 7:]).all(0)
            assert bool((ok | (joint_passage_flag_margin(fo, sp) < 1e-5)).all())
            _close(xk[base:base + 7][:, ok], xp[base:base + 7][:, ok], 2e-3)
        carry = carry_k
    torch.cuda.synchronize()
    assert (F.fused_step_launches, F.rows_step_launches) == (n1 + 3, n2 + 3)


def test_waterfall_kernels_match_plain():
    from vmas_tpu_torch.testing import waterfall_contact_state

    e, world, fo, slots, carry = _joint_env("waterfall", waterfall_contact_state, 10)
    counts = F.contact_counts(world, carry)
    assert all(v > 0 for v in counts.values()), counts
    assert F.joint_counts(world, carry)["torque"] > 0
    g = torch.Generator(device="cuda").manual_seed(11)
    for _ in range(2):
        act = (torch.rand((2 * len(slots), B), generator=g, device="cuda") * 2 - 1) * 0.7
        carry_k, pairs = _both_forms(world, fo, slots, carry, act)
        for (sk, xk), (sp, xp) in pairs:
            _close(sk, sp, 1e-5)
            _close(xk[:fo.base], xp[:fo.base], 2e-5)
            _close(xk[fo.base:], xp[fo.base:], 2e-3)
        # the fixed rotations ride the carry unchanged
        E = len(world.entities)
        assert torch.equal(carry_k[9 * E:], carry[9 * E:])
        carry = carry_k
    torch.cuda.synchronize()


# -- the in-kernel PID velocity controller and k_steps --------------------------

def _pid_acts(e, seed):
    import numpy as np

    from vmas_tpu_torch.testing import pid_actions

    acts = pid_actions(e, np.random.default_rng(seed))
    rows = np.concatenate([np.stack([a[:, 0] for a in acts]), np.stack([a[:, 1] for a in acts])])
    return torch.as_tensor(rows, device="cuda").contiguous()


@pytest.mark.parametrize("name", ["give_way", "multi_give_way"])
def test_pid_kernels_match_plain(name):
    """K2 with the PID hook and K1 against their plain versions from a state
    with contacts and set controller memory: state, scratch and controller
    rows, the emit rows and the controller's output rows."""
    from vmas_tpu_torch import testing

    build = getattr(testing, f"{name}_contact_state")
    e, world, fo, slots, carry = _joint_env(name, build, 12)
    E, R, n_out = len(world.entities), F.rows_layout(world, fo), fo.n_out
    step = F.make_rows_step(world, fo, slots)
    for t in range(3):
        act = _pid_acts(e, 13 + t)
        if t == 0:
            assert all(v > 0 for v in testing.pid_counts(world, fo, carry, act).values())
        ck, ek = step(carry, act)
        cp, ep = F.rows_step_plain(world, fo, slots, carry, act)
        _close(ck[:9 * E], cp[:9 * E], 1e-5)
        _close(ck[R - fo.n_ctrl:], cp[R - fo.n_ctrl:], 1e-5)
        _close(ek[n_out:], ep[n_out:], 1e-5)
        _close(ek[:fo.base], ep[:fo.base], 2e-5)
        assert torch.equal(ek[n_out - 1], ep[n_out - 1])
        _close(ek[fo.base:n_out - 1], ep[fo.base:n_out - 1], 2e-3)
        x = carry[:R - fo.n_ctrl].clone()
        x[6 * E + torch.as_tensor(slots, device="cuda")] = act[:len(slots)]
        x[7 * E + torch.as_tensor(slots, device="cuda")] = act[len(slots):]
        yk, yp = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
        _close(yk[:9 * E], yp[:9 * E], 1e-5)
        _close(yk[9 * E:9 * E + fo.base], yp[9 * E:9 * E + fo.base], 2e-5)
        _close(yk[9 * E + fo.base:], yp[9 * E + fo.base:], 2e-3)
        carry = ck
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["transport", "give_way"])
def test_k_steps_launch_equals_single_steps(name):
    """One launch of 4 env steps gives bitwise the carry and output rows of
    4 launches of one step, and holds them to the plain version's 4 steps:
    state and controller rows and the controller's output atol 1e-5,
    observation rows 2e-5, scratch, reward, shaping and flag rows 2e-3."""
    _cuda()
    e = make_env(name, B, device="cuda", seed=0, fused_physics=True)
    world, fo = e.world, e._fused_outputs
    slots = [a.index for a in e.agents]
    carry = F.pack_carry(world, e.state, fo)
    g = torch.Generator(device="cuda").manual_seed(14)
    act = ((torch.rand((4 * 2 * len(slots), B), generator=g, device="cuda") * 2 - 1) * 0.6).contiguous()
    one, four = F.make_rows_step(world, fo, slots), F.make_rows_step(world, fo, slots, k_steps=4)
    c4, e4 = four(carry, act)
    c1, blocks = carry, []
    A2 = 2 * len(slots)
    for k in range(4):
        c1, e1 = one(c1, act[k * A2:(k + 1) * A2].contiguous())
        blocks.append(e1)
    torch.cuda.synchronize()
    assert torch.equal(c4, c1) and torch.equal(e4, torch.cat(blocks))
    cp, ep = F.rows_step_plain(world, fo, slots, carry, act, 4)
    E, R, n_out = len(world.entities), F.rows_layout(world, fo), fo.n_out
    n_tot, obs_end = n_out + fo.n_ctrl_out, fo.n_agents * fo.obs_w
    _close(c4[:9 * E], cp[:9 * E], 1e-5)
    _close(c4[9 * E:R - fo.n_ctrl], cp[9 * E:R - fo.n_ctrl], 2e-3)
    _close(c4[R - fo.n_ctrl:], cp[R - fo.n_ctrl:], 1e-5)
    for k in range(4):
        ek, epk = e4[k * n_tot:(k + 1) * n_tot], ep[k * n_tot:(k + 1) * n_tot]
        _close(ek[:obs_end], epk[:obs_end], 2e-5)
        _close(ek[obs_end:n_out], epk[obs_end:n_out], 2e-3)
        _close(ek[n_out:], epk[n_out:], 1e-5)


# -- dynamic gravity (wind_flocking), the MPE emits, the op-cost probe ----------

def test_dynamic_gravity_kernel_matches_plain():
    """K1 with the dynamic-gravity rows (wind_flocking: the big agent's
    wind a random share of the full wind) bitwise its plain version over 3
    re-synced steps, and the world's rows form refused by the launcher."""
    import numpy as np

    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.testing import wind_flocking_state

    _cuda()
    e = make_env("wind_flocking", B, device="cuda", seed=0, fused_physics=True)
    world = e.world
    s = state_from_numpy(world, wind_flocking_state(e, np.random.default_rng(15)))
    n = F.fused_step_launches
    for _ in range(3):
        sk = F.fused_physics_step(world, s)
        x = torch.cat([F.state_rows(s), s.joint_fixed_rot.T, s.dyn_gravity[..., 0].T,
                       s.dyn_gravity[..., 1].T]).contiguous()
        y = F.fused_step_plain(world, x)
        assert torch.equal(F.state_rows(sk), y)
        s = sk
    torch.cuda.synchronize()
    assert F.fused_step_launches == n + 3


@pytest.mark.parametrize("name", ["simple", "simple_spread"])
def test_mpe_kernels_match_plain(name):
    """K2 and K1 with simple's and simple_spread's emits bitwise their plain
    versions over 3 re-synced steps (simple: the empty pair table), and a
    launch of 4 steps bitwise 4 launches of one."""
    from vmas_tpu_torch.testing import mpe_state

    e, world, fo, slots, carry = _joint_env(name, mpe_state, 16)
    g = torch.Generator(device="cuda").manual_seed(17)
    for _ in range(3):
        act = (torch.rand((2 * len(slots), B), generator=g, device="cuda") * 2 - 1).contiguous()
        carry_k, pairs = _both_forms(world, fo, slots, carry, act)
        for (sk, xk), (sp, xp) in pairs:
            assert torch.equal(sk, sp) and torch.equal(xk, xp)
        carry = carry_k
    act = ((torch.rand((4 * 2 * len(slots), B), generator=g, device="cuda") * 2 - 1)).contiguous()
    c4, e4 = F.make_rows_step(world, fo, slots, k_steps=4)(carry, act)
    c1, blocks, A2 = carry, [], 2 * len(slots)
    for k in range(4):
        c1, e1 = F.make_rows_step(world, fo, slots)(c1, act[k * A2:(k + 1) * A2].contiguous())
        blocks.append(e1)
    torch.cuda.synchronize()
    assert torch.equal(c4, c1) and torch.equal(e4, torch.cat(blocks))


MPE_FAMILY = ["simple_push", "simple_adversary", "simple_tag", "simple_reference", "simple_speaker_listener",
              "simple_world_comm"]


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("name", MPE_FAMILY)
def test_mpe_family_kernels_bitwise_plain(name, lanes):
    """K2 (one and 4 env steps per launch) and K1 with each of the other MPE
    emits bitwise their plain versions at 4099 envs (a ragged last block at
    every group count), in the one-thread form and the 8-lane form, from a
    state with catches, contacts and food in reach."""
    import numpy as np

    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.testing import mpe_family_state

    _cuda()
    width = 4096 + 3
    e = make_env(name, width, device="cuda", seed=0, fused_physics=True)
    world, fo = e.world, e._fused_outputs
    ks = F._kernel_spec(world)
    slots, A2 = [a.index for a in e.agents], 2 * len(e.agents)
    carry = F.pack_carry(world, state_from_numpy(world, mpe_family_state(e, np.random.default_rng(23))), fo)
    g = torch.Generator(device="cuda").manual_seed(24)
    act = ((torch.rand((4 * A2, width), generator=g, device="cuda") * 2 - 1)).contiguous()
    rule, ks.lanes = ks.lanes, lanes
    try:
        for k in (1, 4):
            ck, ek = F.make_rows_step(world, fo, slots, k_steps=k)(carry, act[:k * A2].contiguous())
            cp, ep = F.rows_step_plain(world, fo, slots, carry, act[:k * A2], k)
            assert torch.equal(ck, cp) and torch.equal(ek, ep), k
        x = with_actions_rows(carry, act[:A2], slots, len(world.entities))
        assert torch.equal(F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo))
        torch.cuda.synchronize()
    finally:
        ks.lanes = rule


def test_world_comm_rows_rollout_on_the_card_equals_step_rollout():
    """simple_world_comm's rows rollout (K2, the leader's comm state given
    to unpack per step) against its env.step rollout (K1) at 4099 envs,
    bitwise."""
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn

    _cuda()
    e = make_env("simple_world_comm", 4096 + 3, device="cuda", seed=0, fused_physics=True)
    s0, st0 = e.state, e.steps
    sa, _, ta = rollout_fn(e, horizon=6)(s0, st0, torch.Generator(device="cuda").manual_seed(9))
    sb, _, tb = rows_rollout_fn(e, horizon=6)(s0, st0, torch.Generator(device="cuda").manual_seed(9))
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(a, b) for a, b in zip(ta["obs"], tb["obs"]))
    for field in ("pos", "vel", "c", "uc"):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field


@pytest.mark.parametrize("block", [32, 128, 256])
@pytest.mark.parametrize("trans", [False, True])
def test_opcost_kernel_matches_plain(trans, block):
    """The op-cost probe at 54 rows and a ragged width: the ALU chain
    bitwise its plain version, the transcendental chain rtol 1e-5 atol
    1e-6 (the card's exp and log1p in two builds), the copied rows bitwise;
    bad arguments raise."""
    from vmas_tpu_torch import opcost

    _cuda()
    g = torch.Generator(device="cuda").manual_seed(18)
    x = (torch.rand((54, B), generator=g, device="cuda") * 1.5 + 0.5).contiguous()
    n = opcost.opcost_launches
    for n_ops in (0, 1, 2, 3, 100, 301):
        y, p = opcost.opcost_chain(x, n_ops, trans, block), opcost.opcost_chain_plain(x, n_ops, trans)
        assert torch.equal(y[1:], x[1:])
        if trans:
            _close(y[0], p[0], 1e-6)
        else:
            assert torch.equal(y[0], p[0])
    torch.cuda.synchronize()
    assert opcost.opcost_launches == n + 6
    with pytest.raises(ValueError, match="block"):
        opcost.opcost_chain(x, 10, trans, 48)
    with pytest.raises(ValueError, match="contiguous"):
        opcost.opcost_chain(x.t().contiguous().t(), 10, trans)


# -- road_traffic: path sweeps and all-ego observations ------------------------

# 37 x 20 = 740 lanes: the last 128-thread block is ragged
RT_B = 37


def _rt_env(**kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the road_traffic kernels have no CPU mode")
    return make_env("road_traffic", RT_B, device="cuda", is_add_noise=False, **kw)


@pytest.fixture
def rt_env():
    e = _rt_env(seed=0)
    for _ in range(4):
        e.step(e.get_random_actions())
    return e


def _rt_lanes(env):
    pos, rot, _ = env.scenario._agent_arrays(env.state)
    return env.state.scenario["path_id"].contiguous(), pos.contiguous(), rot.contiguous()


def test_rt_sweep_kernel_matches_plain(rt_env):
    sc = rt_env.scenario
    lanes = _rt_lanes(rt_env)
    n = rtk.sweep_launches
    got = rtk.sweep_all(sc._sweep_tables, *lanes, **sc.sweep_kw)
    torch.cuda.synchronize()
    assert rtk.sweep_launches == n + 1
    want = rtk.sweep_all_plain(sc._sweep_tables, *lanes, **sc.sweep_kw)
    for k in ("idx_ref", "idx_l", "idx_r", "coll_l", "coll_r", "short_term"):
        assert torch.equal(got[k], want[k]), k
    for k in ("d_ref", "dl5", "dr5"):
        _close(got[k], want[k], 1e-6, 0.0)


def test_rt_obs_kernel_matches_plain(rt_env):
    sc = rt_env.scenario
    xs = sc.obs_inputs(rt_env.state)
    n = rtk.obs_launches
    got = rtk.obs_all(*xs, **sc.obs_kw)
    torch.cuda.synchronize()
    assert rtk.obs_launches == n + 1
    want = rtk.obs_all_plain(*xs, **sc.obs_kw)
    assert got.shape == want.shape == (20, RT_B, 32)
    # far-masked neighbour slots hold exactly 1.0 in their distance column
    far = [10 + 11 * k + 10 for k in range(sc.obs_kw["K"])]
    assert torch.equal(got[..., far] == 1.0, want[..., far] == 1.0)
    _close(got, want, 1e-6, 0.0)


def test_rt_env_with_kernels_matches_plain_path():
    envs = [_rt_env(seed=1, pallas_sweeps=k, pallas_obs=k) for k in (True, False)]
    g = torch.Generator(device="cuda").manual_seed(2)
    for _ in range(3):
        acts = [torch.rand((RT_B, 2), generator=g, device="cuda") * 2 - 1 for _ in range(20)]
        (ok, rk, dk, _), (op, rp, dp, _) = (e.step(acts) for e in envs)
        for a, b in zip([*ok, *rk], [*op, *rp]):
            _close(a, b, 5e-5, 0.0)
        assert torch.equal(dk, dp)


def test_rt_wrappers_reject_bad_input(rt_env):
    sc = rt_env.scenario
    pid, pos, rot = _rt_lanes(rt_env)
    with pytest.raises(ValueError, match="float32"):
        rtk.sweep_all(sc._sweep_tables, pid, pos.double(), rot, **sc.sweep_kw)
    with pytest.raises(ValueError, match="contiguous"):
        rtk.sweep_all(sc._sweep_tables, pid, pos, rot.t().contiguous().t(), **sc.sweep_kw)
    xs = list(sc.obs_inputs(rt_env.state))
    with pytest.raises(ValueError, match="K must be"):
        rtk.obs_all(*xs, **{**sc.obs_kw, "K": 20})


def _bits(x):
    """A float tensor's bits, so that equal NaNs compare equal."""
    return x.view(torch.int32)


@pytest.mark.parametrize("width", [301, 4099])
def test_rt_sweep_group_forms_bitwise_one_thread(width):
    """The path-sweep kernel's group form (every group size built) bitwise
    its one-thread form on all 16 + 2S rows, and against the plain version
    as the default form is (indices, flags, short-term points equal;
    distances atol 1e-6): at widths of 301 x 20 and 4099 x 20 lanes
    (ragged for every group count), on stepped lanes, on chip_smoke.py's centre-line vertex, padded
    tail and left-boundary vertex lanes, and with invalid path ids (NaN
    rows)."""
    from vmas_tpu_torch import testing

    _cuda()
    e = make_env("road_traffic", width, device="cuda", seed=3, is_add_noise=False)
    for _ in range(2):
        e.step(e.get_random_actions())
    sc, T = e.scenario, e.scenario._sweep_tables
    pid, on_c, on_l, rot = testing.rt_vertex_lanes(T, width, sc.n_agents, "cuda")
    bad = pid.clone()
    bad[0, 0], bad[1, 3] = -1, T.center.shape[0]
    for case in (_rt_lanes(e), (pid, on_c, rot), (pid, on_l, rot)):
        ref = rtk.sweep_rows(T, *case, lanes=1, **sc.sweep_kw)
        want = rtk.sweep_all_plain(T, *case, **sc.sweep_kw)
        for lanes in rtk.SWEEP_LANES_BUILT[1:]:
            assert torch.equal(_bits(rtk.sweep_rows(T, *case, lanes=lanes, **sc.sweep_kw)), _bits(ref)), lanes
            got = rtk.sweep_all(T, *case, lanes=lanes, **sc.sweep_kw)
            for k in ("idx_ref", "idx_l", "idx_r", "coll_l", "coll_r", "short_term"):
                assert torch.equal(got[k], want[k]), (lanes, k)
            for k in ("d_ref", "dl5", "dr5"):
                _close(got[k], want[k], 1e-6, 0.0)
    ref = rtk.sweep_rows(T, bad, on_c, rot, lanes=1, **sc.sweep_kw)  # lane n = b * A + a
    assert bool(ref[:, 0].isnan().all()) and bool(ref[:, sc.n_agents + 3].isnan().all())
    for lanes in rtk.SWEEP_LANES_BUILT[1:]:
        assert torch.equal(_bits(rtk.sweep_rows(T, bad, on_c, rot, lanes=lanes, **sc.sweep_kw)), _bits(ref)), lanes
    torch.cuda.synchronize()


def _rt_obs_inputs(B, A, S=3, seed=0):
    """Random egos on the card, with exact distance ties (in every env,
    agents 1 and 2 mirror each other about agent 0) and agents beyond the
    mask threshold."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *sh: torch.rand(sh, generator=g) * 2 - 1
    pos = u(B, A, 2) * 2.5
    pos[:, 1] = pos[:, 0] + torch.tensor([0.3, 0.4])
    pos[:, 2] = pos[:, 0] + torch.tensor([-0.3, 0.4])
    rot = u(B, A) * 3.14159
    verts = pos[:, :, None] + u(B, A, 5, 2) * 0.1
    xs = [pos, rot, u(B, A, 2), pos[:, :, None] + u(B, A, S, 2) * 0.3, verts,
          u(B, A).abs() * 0.2, u(B, A).abs() * 0.2, u(B, A).abs() * 0.2]
    return [x.contiguous().cuda() for x in xs]


@pytest.mark.parametrize("B,A,K", [(301, 20, 2), (4099, 20, 2), (301, 4, 3), (301, 20, rtk.K_MAX_OBS)])
def test_rt_obs_tile_forms_bitwise_one_thread(B, A, K):
    """The observation kernel at every tile its rule picks (8, 4, 2, 1)
    bitwise its one-thread form, and against the plain version (far masks
    equal, values atol 1e-6), at ragged B, at A = 4 with K = 3 and at
    K = K_MAX_OBS."""
    _cuda()
    xs = _rt_obs_inputs(B, A)
    kw = dict(K=K, apply_mask=True, norm_pos=1.6, norm_v=1.0, norm_dist=0.45, thresh=1.6)
    ref = rtk.obs_all(*xs, **kw, tile=0)
    want = rtk.obs_all_plain(*xs, **kw)
    far = [10 + 11 * k + 10 for k in range(K)]
    assert bool((want[..., far] == 1.0).any()) and not bool((want[..., far] == 1.0).all())
    for tile in (1, 2, 4, 8):
        got = rtk.obs_all(*xs, **kw, tile=tile)
        assert torch.equal(_bits(got), _bits(ref)), tile
        assert torch.equal(got[..., far] == 1.0, want[..., far] == 1.0), tile
        _close(got, want, 1e-6, 0.0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("A", [64, 130])
def test_rt_obs_tile_rule_many_vehicles(A):
    """With more vehicles than a block of 8 envs holds (A = 64: too much
    shared memory; A = 130: more than 1024 threads), the observation
    kernel runs at the smaller tile its rule picks, bitwise its one-thread
    form and against the plain version (far masks equal, values atol
    1e-6); road_traffic steps at that width on the card."""
    _cuda()
    e = make_env("road_traffic", 33, device="cuda", seed=2, n_agents=A, is_add_noise=False)
    obs, _, _, _ = e.step(e.get_random_actions())
    assert all(bool(torch.isfinite(o).all()) for o in obs)
    sc = e.scenario
    S, K = sc.sweep_kw["S"], sc.obs_kw["K"]
    tile = rtk.obs_tile(A, S, K, "cuda")
    assert 0 < tile < rtk.OBS_TILE and tile * A <= 1024
    xs = sc.obs_inputs(e.state)
    got = rtk.obs_all(*xs, **sc.obs_kw)
    assert torch.equal(_bits(got), _bits(rtk.obs_all(*xs, **sc.obs_kw, tile=0)))
    want = rtk.obs_all_plain(*xs, **sc.obs_kw)
    far = [1 + 2 * S + 3 + 11 * k + 10 for k in range(K)]
    assert torch.equal(got[..., far] == 1.0, want[..., far] == 1.0)
    _close(got, want, 1e-6, 0.0)
    torch.cuda.synchronize()


def test_rt_wrappers_reject_forms_not_built(rt_env):
    sc = rt_env.scenario
    lanes = _rt_lanes(rt_env)
    for bad in (2, 3, 4, 16, 32, 64):
        with pytest.raises(ValueError, match="built for lanes"):
            rtk.sweep_all(sc._sweep_tables, *lanes, lanes=bad, **sc.sweep_kw)
    xs = sc.obs_inputs(rt_env.state)
    for bad in (-1, 52):  # 52 envs of 20 agents: more than 1024 threads a block
        with pytest.raises(ValueError, match="tile must be"):
            rtk.obs_all(*xs, tile=bad, **sc.obs_kw)


# -- the lane kernel: every lane count, ragged widths ---------------------------

_LANE_WORLDS = {
    "transport": ({"n_agents": 4}, "transport_contact_state"),
    "joint_passage": ({}, "joint_passage_contact_state"),
    "waterfall": ({}, "waterfall_contact_state"),
    "multi_give_way": ({}, "multi_give_way_contact_state"),
}


_ALL_LANES = {}


def _all_lanes_library():
    """The fused kernel built at every lane count of ``F.LANES``
    (``-DVMAS_FUSED_ALL_LANES``, as tools/time_fused_step.py builds it; the
    package's build holds ``F.LANES_BUILT`` only), built once per session."""
    from vmas_tpu_torch import _kernels as K

    if "lib" not in _ALL_LANES:
        _ALL_LANES["lib"] = K.library("fused_step", K.build_variant("fused_step", ["VMAS_FUSED_ALL_LANES"]))
    return _ALL_LANES["lib"]


@pytest.mark.parametrize("width", [301, 4096 + 3])
@pytest.mark.parametrize("lanes", F.LANES)
@pytest.mark.parametrize("name", list(_LANE_WORLDS))
def test_lane_kernels_bitwise_plain(name, lanes, width, monkeypatch):
    """K2 (one and two env steps per launch) and K1 at every lane count the
    source takes, bitwise their plain versions, at widths that leave the
    last block ragged for every group count (301 is a multiple of none of
    4, 8, 16, 32; 4099 of none). The lane counts the package's build does
    not hold run on the all-lanes build (tools/time_fused_step.py's)."""
    import numpy as np

    from vmas_tpu_torch import _kernels as K
    from vmas_tpu_torch import testing
    from vmas_tpu_torch.interop import state_from_numpy

    _cuda()
    if lanes not in F.LANES_BUILT:
        monkeypatch.setitem(K._LIBS, "fused_step", _all_lanes_library())
    kw, build = _LANE_WORLDS[name]
    e = make_env(name, width, device="cuda", seed=0, fused_physics=True, **kw)
    world, fo = e.world, e._fused_outputs
    ks = F._kernel_spec(world)
    slots = [a.index for a in e.agents]
    rng = np.random.default_rng(19)
    carry = F.pack_carry(world, state_from_numpy(world, getattr(testing, build)(e, rng)), fo)
    if fo.n_ctrl:
        act = torch.cat([_pid_acts(e, 20), _pid_acts(e, 21)])
    else:
        g = torch.Generator(device="cuda").manual_seed(20)
        act = (torch.rand((4 * len(slots), width), generator=g, device="cuda") * 2 - 1) * 0.8
    act = act.contiguous()
    A2, R = 2 * len(slots), F.rows_layout(world, fo)
    rule, ks.lanes = ks.lanes, lanes
    try:
        for k in (1, 2):
            ck, ek = F.make_rows_step(world, fo, slots, k_steps=k)(carry, act[:k * A2].contiguous())
            cp, ep = F.rows_step_plain(world, fo, slots, carry, act[:k * A2], k)
            assert torch.equal(ck, cp) and torch.equal(ek, ep)
        x = with_actions_rows(carry[:R - fo.n_ctrl], act[:A2], slots, len(world.entities))
        assert torch.equal(F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo))
        torch.cuda.synchronize()
    finally:
        ks.lanes = rule


def with_actions_rows(carry, act, slots, E):
    """The fused form's input rows: the carry with the agents' force rows
    set to the action rows."""
    x = carry.clone()
    idx = torch.as_tensor(slots, device=carry.device)
    x[6 * E + idx] = act[:len(slots)]
    x[7 * E + idx] = act[len(slots):]
    return x


def test_launcher_rejects_bad_lanes_and_shared_memory(env):
    """A lane count the kernel does not take, one the package's build does
    not hold (4: the all-lanes build's only), and a block beyond the
    device's shared memory raise; none falls back."""
    from vmas_tpu_torch import _kernels as K

    world, fo = env.world, env._fused_outputs
    ks = F._kernel_spec(world)
    x = F.pack_carry(world, env.state, fo)
    out = torch.empty((9 * ks.E + fo.n_out, B), device="cuda")
    rule = ks.lanes
    try:
        for lanes in (3, 4):
            ks.lanes = lanes
            with pytest.raises(RuntimeError, match="launch failed"):
                F.fused_step(world, x, fo)
    finally:
        ks.lanes = rule
    with pytest.raises(ValueError, match="shared memory"):
        F._launch(ks, ks.to_ctypes(int(fo.n_scratch_in)), fo, x, None, out, None, rows_mode=False, n_tot=100000)
    lib = K.library("fused_step")
    assert lib.vmas_fused_smem(ks.to_ctypes(int(fo.n_scratch_in)), rule, 0, 0, 100000) > lib.vmas_max_smem()


# -- the other holonomic worlds, and the lifted caps -----------------------------

HOLONOMIC = ["reverse_transport", "wheel", "passage", "dispersion", "dropout", "het_mass"]


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("name", HOLONOMIC)
def test_holonomic_kernels_bitwise_plain(name, lanes):
    """K2 (one and 4 env steps per launch; het_mass has no rows form) and K1
    with each of the six emits bitwise their plain versions at 4099 envs,
    one thread per env and 8 lanes per env, from a state with its contacts
    and events (testing.holonomic_state)."""
    import numpy as np

    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.testing import holonomic_state

    _cuda()
    width = 4096 + 3
    e = make_env(name, width, device="cuda", seed=0, fused_physics=True)
    world, fo = e.world, e._fused_outputs
    ks = F._kernel_spec(world)
    slots, A2 = [a.index for a in e.agents], 2 * len(e.agents)
    st = state_from_numpy(world, holonomic_state(e, np.random.default_rng(31)))
    g = torch.Generator(device="cuda").manual_seed(32)
    act = ((torch.rand((4 * A2, width), generator=g, device="cuda") * 2 - 1)).contiguous()
    rule, ks.lanes = ks.lanes, lanes
    try:
        if F.rows_step_supported(world, fo, e.agents):
            carry = F.pack_carry(world, st, fo)
            for k in (1, 4):
                ck, ek = F.make_rows_step(world, fo, slots, k_steps=k)(carry, act[:k * A2].contiguous())
                cp, ep = F.rows_step_plain(world, fo, slots, carry, act[:k * A2], k)
                assert torch.equal(ck, cp) and torch.equal(ek, ep), k
        x = torch.cat([F.state_rows(st), st.joint_fixed_rot.T, fo.scratch_rows(st)]).contiguous()
        assert torch.equal(F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo))
        torch.cuda.synchronize()
    finally:
        ks.lanes = rule


def test_dropout_rows_rollout_on_the_card_equals_step_rollout():
    """dropout's rows rollout (K2, each step's decoded u handed to unpack for
    the energy term, post_rewards once at the end) against its env.step
    rollout (K1) at 4099 envs, bitwise."""
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn

    _cuda()
    e = make_env("dropout", 4096 + 3, device="cuda", seed=0, fused_physics=True)
    s0, st0 = e.state, e.steps
    sa, _, ta = rollout_fn(e, horizon=6)(s0, st0, torch.Generator(device="cuda").manual_seed(9))
    sb, _, tb = rows_rollout_fn(e, horizon=6)(s0, st0, torch.Generator(device="cuda").manual_seed(9))
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(a, b) for a, b in zip(ta["obs"], tb["obs"]))
    for field in ("pos", "vel", "rendering"):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field
    assert all(torch.equal(sa.scenario[k], sb.scenario[k]) for k in sa.scenario)


# -- the joint worlds, and the rows rollouts' noise streams ----------------------

JOINT_WORLDS = {
    "buzz_wire": ("buzz_wire", {}), "ball_trajectory": ("ball_trajectory", {}), "ball_passage": ("ball_passage", {}),
    "joint_passage_size": ("joint_passage_size", {}),
    "joint_passage_size+pid": ("joint_passage_size", {"use_vel_controller": True, "asym_package": True,
                                                      "observe_joint_angle": True, "middle_angle_180": True}),
}


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("config", sorted(JOINT_WORLDS))
def test_joint_worlds_kernels_bitwise_plain(config, lanes):
    """K2 (one and 4 env steps per launch; joint_passage_size+pid with its
    PID) and K1 with each of the four joint worlds' emits bitwise their
    plain versions at 4099 envs, one thread per env and 8 lanes per env,
    from a state with their contacts and events (testing.joint_worlds_state);
    asym_joint's K1 with no emit likewise."""
    import numpy as np

    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.testing import joint_worlds_state

    _cuda()
    width = 4096 + 3
    name, kw = JOINT_WORLDS[config]
    e = make_env(name, width, device="cuda", seed=0, fused_physics=True, **kw)
    world, fo = e.world, e._fused_outputs
    ks = F._kernel_spec(world)
    slots, A2 = [a.index for a in e.agents], 2 * len(e.agents)
    st = state_from_numpy(world, joint_worlds_state(e, np.random.default_rng(33)))
    g = torch.Generator(device="cuda").manual_seed(34)
    act = ((torch.rand((4 * A2, width), generator=g, device="cuda") * 2 - 1)).contiguous()
    rule, ks.lanes = ks.lanes, lanes
    try:
        carry = F.pack_carry(world, st, fo)
        for k in (1, 4):
            ck, ek = F.make_rows_step(world, fo, slots, k_steps=k)(carry, act[:k * A2].contiguous())
            cp, ep = F.rows_step_plain(world, fo, slots, carry, act[:k * A2], k)
            assert torch.equal(ck, cp) and torch.equal(ek, ep), k
        if not fo.n_ctrl:
            x = torch.cat([F.state_rows(st), st.joint_fixed_rot.T, fo.scratch_rows(st)]).contiguous()
            assert torch.equal(F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo))
        torch.cuda.synchronize()
    finally:
        ks.lanes = rule
    a = make_env("asym_joint", width, device="cuda", seed=0, fused_physics=True)
    a.step(a.get_random_actions())
    aks = F._kernel_spec(a.world)
    rule, aks.lanes = aks.lanes, lanes
    try:
        x = torch.cat([F.state_rows(a.state), a.state.joint_fixed_rot.T]).contiguous()
        assert torch.equal(F.fused_step(a.world, x), F.fused_step_plain(a.world, x))
    finally:
        aks.lanes = rule


@pytest.mark.parametrize("config", ["joint_passage_size", "joint_passage_size+pid"])
def test_joint_passage_size_rows_rollouts_on_the_card(config):
    """joint_passage_size's rows rollout (K2; the ``t`` clock set to its
    start value plus the horizon; with its PID in the kernel) and, with its
    observation noise, both rows paths against rollout_fn (K1) at 4099
    envs, bitwise."""
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_policy_rollout_fn, rows_rollout_fn

    _cuda()
    name, kw = JOINT_WORLDS[config]
    for noise in ({}, {"observe_joint_angle": True, "joint_angle_obs_noise": 0.2, "obs_noise": 0.1}):
        e = make_env(name, 4096 + 3, device="cuda", seed=0, fused_physics=True, **{**kw, **noise})
        s0, st0 = e.state, e.steps

        def policy(obs, generator):
            return tuple(torch.tanh(o[:, :2] * 3) for o in obs)

        for rows, ref in ((rows_rollout_fn(e, horizon=6, k_steps=2), rollout_fn(e, horizon=6)),
                          (rows_policy_rollout_fn(e, policy, 6), rollout_fn(e, policy, 6))):
            out = []
            for run in (ref, rows):
                e.scenario.obs_seed = 3
                out.append(run(s0, st0, torch.Generator(device="cuda").manual_seed(9)))
            (sa, _, ta), (sb, _, tb) = out
            assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
            assert all(torch.equal(x, y) for x, y in zip(ta["obs"], tb["obs"]))
            for field in ("pos", "vel", "rot", "ang_vel"):
                assert torch.equal(getattr(sa, field), getattr(sb, field)), field
            assert torch.equal(sb.scenario["t"], s0.scenario["t"] + 6)


# -- the sensor worlds -----------------------------------------------------------

SENSOR_WORLDS = {
    "navigation": ("navigation", {}), "navigation,all_goals": ("navigation", {"shared_rew": False,
                                                                              "observe_all_goals": True}),
    "flocking": ("flocking", {}), "discovery": ("discovery", {}),
    "discovery,penalty": ("discovery", {"shared_reward": True, "agent_collision_penalty": -1.0,
                                        "targets_respawn": False}),
}


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("config", sorted(SENSOR_WORLDS))
def test_sensor_worlds_kernels_bitwise_plain(config, lanes):
    """K1 with each sensor world's emit, and K2 (one and 4 env steps per
    launch; flocking's target on the action rows) with navigation's and
    flocking's, bitwise their plain versions at 4099 envs, one thread per
    env and 8 lanes per env, from a state with their events
    (testing.sensor_state)."""
    import numpy as np

    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.testing import sensor_state

    _cuda()
    width = 4096 + 3
    name, kw = SENSOR_WORLDS[config]
    e = make_env(name, width, device="cuda", seed=0, fused_physics=True, **kw)
    world, fo = e.world, e._fused_outputs
    ks = F._kernel_spec(world)
    slots = [a.index for a in e.agents] + list(getattr(fo, "script_slots", ()))
    A2 = 2 * len(slots)
    st = state_from_numpy(world, sensor_state(e, np.random.default_rng(35)))
    g = torch.Generator(device="cuda").manual_seed(36)
    act = ((torch.rand((4 * A2, width), generator=g, device="cuda") * 2 - 1)).contiguous()
    rule, ks.lanes = ks.lanes, lanes
    try:
        if F.rows_step_supported(world, fo, e.agents):
            carry = F.pack_carry(world, st, fo)
            for k in (1, 4):
                ck, ek = F.make_rows_step(world, fo, slots, k_steps=k)(carry, act[:k * A2].contiguous())
                cp, ep = F.rows_step_plain(world, fo, slots, carry, act[:k * A2], k)
                assert torch.equal(ck, cp) and torch.equal(ek, ep), k
        x = torch.cat([F.state_rows(st), st.joint_fixed_rot.T, fo.scratch_rows(st)]).contiguous()
        assert torch.equal(F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo))
        torch.cuda.synchronize()
    finally:
        ks.lanes = rule


@pytest.mark.parametrize("name", ["navigation", "flocking"])
def test_sensor_worlds_rows_rollouts_on_the_card(name):
    """navigation's rows rollout (K2, the Lidar on each step's state rebuilt
    from its carry rows, in chunks of steps) and flocking's (the target's
    script on the action rows) against rollout_fn (K1) at 4099 envs,
    bitwise."""
    import importlib

    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn

    _cuda()
    R = importlib.import_module("vmas_tpu_torch.parallel.rollout")
    e = make_env(name, 4096 + 3, device="cuda", seed=0, fused_physics=True)
    s0, st0 = e.state, e.steps
    sa, _, ta = rollout_fn(e, horizon=6)(s0, st0, torch.Generator(device="cuda").manual_seed(9))
    chunk, R._STATE_CHUNK = R._STATE_CHUNK, 2 * (4096 + 3)
    try:
        sb, _, tb = rows_rollout_fn(e, horizon=6)(s0, st0, torch.Generator(device="cuda").manual_seed(9))
    finally:
        R._STATE_CHUNK = chunk
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(x, y) for x, y in zip(ta["obs"], tb["obs"]))
    for field in ("pos", "vel", "rot", "ang_vel"):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field
    assert all(torch.equal(x, y) for x, y in zip(sa.u, sb.u))


# -- football -------------------------------------------------------------------

FOOTBALL = {"ai_red": {}, "two_teams": {"ai_red_agents": False}}


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("config", sorted(FOOTBALL))
def test_football_kernels_bitwise_plain(config, lanes):
    """K1 with football's emit (both fused configs), and K2 (one and 4 env
    steps per launch) with its emit and the ball's script in the kernel
    (both teams policies), bitwise their plain versions at 4099 envs, one
    thread per env and 8 lanes per env, from a state with goals, the ball
    at rest, near the walls and in the goal mouth
    (testing.football_state); the impulse rows non-zero in some envs."""
    import numpy as np

    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.testing import football_state

    _cuda()
    width = 4096 + 3
    e = make_env("football", width, device="cuda", seed=0, fused_physics=True, **FOOTBALL[config])
    world, fo = e.world, e._fused_outputs
    ks = F._kernel_spec(world)
    slots = [a.index for a in e.agents]
    A2 = 2 * len(slots)
    st = state_from_numpy(world, football_state(e, np.random.default_rng(37)))
    g = torch.Generator(device="cuda").manual_seed(38)
    act = ((torch.rand((4 * A2, width), generator=g, device="cuda") * 2 - 1)).contiguous()
    rule, ks.lanes = ks.lanes, lanes
    try:
        if F.rows_step_supported(world, fo, e.agents):
            carry = F.pack_carry(world, st, fo)
            for k in (1, 4):
                ck, ek = F.make_rows_step(world, fo, slots, k_steps=k)(carry, act[:k * A2].contiguous())
                cp, ep = F.rows_step_plain(world, fo, slots, carry, act[:k * A2], k)
                assert torch.equal(ck, cp) and torch.equal(ek, ep), k
            assert bool((ek[fo.n_out:fo.n_out + 2] != 0).any())
        x = torch.cat([F.state_rows(st), st.joint_fixed_rot.T, fo.scratch_rows(st)]).contiguous()
        assert torch.equal(F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo))
        torch.cuda.synchronize()
    finally:
        ks.lanes = rule


def test_football_rows_rollouts_on_the_card():
    """football with both teams as policies: rows_rollout_fn (K2 with the
    ball's script, k_steps 1 and 4) and rows_policy_rollout_fn against
    rollout_fn (K1, the script and the red mirror in the hooks) at 4099
    envs, bitwise, the final state and u included."""
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_policy_rollout_fn, rows_rollout_fn

    _cuda()
    e = make_env("football", 4096 + 3, device="cuda", seed=0, fused_physics=True, ai_red_agents=False)
    s0, st0 = e.state, e.steps
    W = (torch.rand((56, 2), generator=torch.Generator(device="cuda").manual_seed(4), device="cuda") * 2 - 1) * 0.5
    policy = lambda obs, gen: tuple(torch.tanh(o @ W) for o in obs)
    runs = [(rollout_fn(e, horizon=8), rows_rollout_fn(e, horizon=8)),
            (rollout_fn(e, horizon=8), rows_rollout_fn(e, horizon=8, k_steps=4)),
            (rollout_fn(e, policy, 8), rows_policy_rollout_fn(e, policy, 8))]
    for run_a, run_b in runs:
        sa, _, ta = run_a(s0, st0, torch.Generator(device="cuda").manual_seed(9))
        sb, _, tb = run_b(s0, st0, torch.Generator(device="cuda").manual_seed(9))
        assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
        assert all(torch.equal(x, y) for x, y in zip(ta["obs"], tb["obs"]))
        for field in ("pos", "vel", "rot", "ang_vel", "force"):
            assert torch.equal(getattr(sa, field), getattr(sb, field)), field
        assert all(torch.equal(x, y) for x, y in zip(sa.u, sb.u))


@pytest.mark.parametrize("n", [17, 30])
def test_wide_simple_spread_kernels_bitwise_plain(n):
    """simple_spread with 17 and 30 agents (34 and 60 entities, beyond the
    old 32-entity cap) through K2 and K1 at the lanes the rule picks (8, and
    one thread per env where a block of 8 lanes would not fit its 3661 emit
    rows), bitwise their plain versions at 4099 envs."""
    import numpy as np

    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.testing import mpe_state

    _cuda()
    width = 4096 + 3
    e = make_env("simple_spread", width, device="cuda", seed=0, fused_physics=True, n_agents=n)
    world, fo = e.world, e._fused_outputs
    assert F._kernel_spec(world).lanes == (8 if n == 17 else 1)
    slots, A2 = [a.index for a in e.agents], 2 * n
    carry = F.pack_carry(world, state_from_numpy(world, mpe_state(e, np.random.default_rng(33))), fo)
    g = torch.Generator(device="cuda").manual_seed(34)
    act = ((torch.rand((A2, width), generator=g, device="cuda") * 2 - 1)).contiguous()
    ck, ek = F.make_rows_step(world, fo, slots)(carry, act)
    cp, ep = F.rows_step_plain(world, fo, slots, carry, act)
    assert torch.equal(ck, cp) and torch.equal(ek, ep)
    x = with_actions_rows(carry, act, slots, len(world.entities))
    assert torch.equal(F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo))
    torch.cuda.synchronize()


@pytest.mark.parametrize("name,kw", [("passage", {}), ("give_way", {}), ("simple_spread", {"n_agents": 17}),
                                     ("wind_flocking", {}), ("waterfall", {})])
def test_group_smem_bytes_match_the_launcher(name, kw):
    """core.fused.group_smem_bytes, the host's count behind the lane rule's
    shared-memory fit, equals the launcher's vmas_fused_smem in both forms
    at every lane count of the group form."""
    from vmas_tpu_torch import _kernels as K

    _cuda()
    e = make_env(name, 8, device="cuda", seed=0, fused_physics=True, **kw)
    ks, fo = F._kernel_spec(e.world), e._fused_outputs
    lib = K.library("fused_step")
    k_in, n_out = (int(fo.n_scratch_in), int(fo.n_out)) if fo is not None else (0, 0)
    slots = [a.index for a in e.agents]
    for lanes in (4, 8, 16, 32):
        assert lib.vmas_fused_smem(ks.to_ctypes(k_in), lanes, 0, 0, n_out) == F.group_smem_bytes(
            ks, False, k_in, 0, n_out, 0, lanes)
        if fo is not None and not ks.dyn_gravity:
            n_ctrl, n_tot = int(fo.n_ctrl), n_out + int(fo.n_ctrl_out)
            assert lib.vmas_fused_smem(ks.to_ctypes(k_in, slots), lanes, 1, n_ctrl, n_tot) == F.group_smem_bytes(
                ks, True, k_in, n_ctrl, n_tot, len(slots), lanes)


# -- the PPO path: policy rollouts and an update on the card -------------------

def _ppo_env_model(num_envs):
    _cuda()
    from vmas_tpu_torch.parallel import init_actor_critic, obs_dim_of

    env = make_env("transport", num_envs, device="cuda", seed=0, n_agents=4, fused_physics=True)
    model = init_actor_critic(obs_dim_of(env), 2, generator=torch.Generator(device="cuda").manual_seed(0))
    return env, model


def test_rows_policy_rollout_on_the_card_equals_step_policy_rollout():
    """At a ragged width (4099 envs), the rows policy rollout (K2 a step)
    and the env.step policy rollout (K1 a step) from one state and one
    seed: bitwise in the trajectory, the recorded samples and the final
    state."""
    from vmas_tpu_torch.parallel import make_gaussian_policy, rollout_fn, rows_policy_rollout_fn

    env, model = _ppo_env_model(4099)
    pol = make_gaussian_policy(env)
    policy = lambda obs, g: pol(model, obs, g)
    F.fused_step_launches = F.rows_step_launches = 0
    sa, _, ta = rollout_fn(env, policy, 8, policy_aux=True)(env.state, env.steps,
                                                            torch.Generator(device="cuda").manual_seed(4))
    sb, _, tb = rows_policy_rollout_fn(env, policy, 8, policy_aux=True)(env.state, env.steps,
                                                                        torch.Generator(device="cuda").manual_seed(4))
    assert (F.fused_step_launches, F.rows_step_launches) == (8, 8)
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(a, b) for a, b in zip(ta["obs"], tb["obs"]))
    for k in ("raw", "logp"):
        assert torch.equal(ta["policy_aux"][k], tb["policy_aux"][k]), k
    for name in ("pos", "vel", "rot", "ang_vel", "force", "torque"):
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    assert not torch.equal(sb.pos, env.state.pos)


def test_ppo_bf16_rows_update_on_the_card():
    """One bf16 collect="rows" update on the card: one K2 launch per
    collection step, a finite loss, parameters finite and moved."""
    from vmas_tpu_torch.parallel import make_ppo_update

    env, model = _ppo_env_model(1000)
    update, make_opt = make_ppo_update(env, horizon=16, collect="rows", epochs=2, compute_dtype=torch.bfloat16)
    p0 = [p.detach().clone() for p in model.parameters()]
    F.fused_step_launches = F.rows_step_launches = 0
    _, steps, metrics = update(model, make_opt(model), env.state, env.steps,
                               torch.Generator(device="cuda").manual_seed(1))
    assert (F.fused_step_launches, F.rows_step_launches) == (0, 16)
    assert bool(torch.isfinite(metrics["loss"])) and bool((steps == 16).all())
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert all(not torch.equal(p, q) for p, q in zip(model.parameters(), p0))


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("name", ["diff_drive", "kinematic_bicycle", "drone", "goal", "vel_control",
                                  "circle_trajectory", "line_trajectory"])
def test_debug_worlds_kernel_bitwise_plain(name, lanes):
    """K1 with no emit bitwise its plain version at 4099 envs, one thread
    per env and 8 lanes per env, over 3 steps from testing.debug_world_state
    (the first agents in contact, the drone tilted, the controllers'
    memory set), each step's input rows those of its hooks (the dynamics
    models' and the controllers' forces and torques), the env stepped on
    through the kernel; the drone's u at its spawn width after the steps."""
    import numpy as np

    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.testing import debug_world_actions, debug_world_state

    _cuda()
    width = 4096 + 3
    e = make_env(name, width, device="cuda", seed=0, fused_physics=True)
    assert e._fused_outputs is None and e.world.fused
    ks = F._kernel_spec(e.world)
    e.state = state_from_numpy(e.world, debug_world_state(e, np.random.default_rng(35)))
    rule, ks.lanes = ks.lanes, lanes
    try:
        for t in range(3):
            acts = [torch.as_tensor(a, device="cuda") for a in debug_world_actions(e, np.random.default_rng(36 + t))]
            st = e._act(e.state, acts, [(None, None)] * e.n_agents)
            x = torch.cat([F.state_rows(st), st.joint_fixed_rot.T]).contiguous()
            assert torch.equal(F.fused_step(e.world, x), F.fused_step_plain(e.world, x)), t
            e.step(acts)
        torch.cuda.synchronize()
    finally:
        ks.lanes = rule
    assert all(u.shape == (width, a.action_size) for u, a in zip(e.state.u, e.world.agents))


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("key", ["painting", "painting_full", "construction", "sampling"])
def test_dots_worlds_kernel_bitwise_plain(key, lanes):
    """K1 with no emit bitwise its plain version at 4099 envs, one thread
    per env and 8 lanes per env, over 3 steps from testing.dots_world_state
    (agents pressed into the walls or the bound and into each other), the
    env stepped on through the kernel; sampling's visited cells and
    observations after the steps bitwise those of the same steps on the
    CPU."""
    import numpy as np

    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.testing import DOTS_WORLDS, dots_world_actions, dots_world_state

    _cuda()
    width = 4096 + 3
    name, kw = DOTS_WORLDS[key]
    envs = {dev: make_env(name, width, device=dev, seed=0, fused_physics=True, **kw) for dev in ("cuda", "cpu")}
    e = envs["cuda"]
    assert e._fused_outputs is None and e.world.fused
    ks = F._kernel_spec(e.world)
    e.state = state_from_numpy(e.world, dots_world_state(envs["cpu"], np.random.default_rng(45)))
    rule, ks.lanes = ks.lanes, lanes
    try:
        for t in range(3):
            acts = dots_world_actions(e, np.random.default_rng(46 + t))
            st = e._act(e.state, [torch.as_tensor(a, device="cuda") for a in acts], [(None, None)] * e.n_agents)
            x = torch.cat([F.state_rows(st), st.joint_fixed_rot.T]).contiguous()
            assert torch.equal(F.fused_step(e.world, x), F.fused_step_plain(e.world, x)), t
            e.step([torch.as_tensor(a, device="cuda") for a in acts])
        torch.cuda.synchronize()
    finally:
        ks.lanes = rule
    if key == "sampling":
        # the visited cells from the card's positions, on the card and on the CPU
        sc, scc = e.scenario, envs["cpu"].scenario
        scr = {k: v.cpu() for k, v in e.state.scenario.items()}
        for a, ac in zip(e.world.agents, envs["cpu"].world.agents):
            v, s_gpu = sc._sample(e.state.scenario, a.pos(e.state), update_sampled_flag=True)
            vc, s_cpu = scc._sample(scr, ac.pos(e.state).cpu(), update_sampled_flag=True)
            assert torch.equal(s_gpu["sampled"].cpu(), s_cpu["sampled"]) and torch.equal(v.cpu(), vc)


@pytest.mark.parametrize("kw", [dict(map_type="3", n_agents=10),
                                dict(map_type="3", n_agents=4, scenario_probabilities=[0.4, 0.3, 0.3]),
                                dict(map_type="2"), dict(is_testing_mode=True)],
                         ids=["map3", "map3_mixed", "map2", "testing"])
def test_rt_kernels_on_other_maps_match_plain(kw):
    """road_traffic's path sweeps and observations on map 3's tables (32
    paths) and in maps 2 and testing mode at 4099 envs, after 4 random
    steps: the group form bitwise the one-thread form, indices, flags,
    short-term points and chosen neighbours equal to the plain version's,
    values atol 1e-6; two sweeps a step in map 3 and testing mode."""
    _cuda()
    e = make_env("road_traffic", 4096 + 3, device="cuda", seed=0, is_add_noise=False, **kw)
    n = rtk.sweep_launches
    for _ in range(4):
        e.step(e.get_random_actions())
    torch.cuda.synchronize()
    per_step = 2 if kw.get("map_type") == "3" or kw.get("is_testing_mode") else 1
    assert rtk.sweep_launches - n == 4 * per_step
    sc = e.scenario
    lanes = _rt_lanes(e)
    one = rtk.sweep_rows(sc._sweep_tables, *lanes, lanes=1, **sc.sweep_kw)
    assert torch.equal(rtk.sweep_rows(sc._sweep_tables, *lanes, **sc.sweep_kw).view(torch.int32),
                       one.view(torch.int32))
    got = rtk.sweep_all(sc._sweep_tables, *lanes, **sc.sweep_kw)
    want = rtk.sweep_all_plain(sc._sweep_tables, *lanes, **sc.sweep_kw)
    for k in ("idx_ref", "idx_l", "idx_r", "coll_l", "coll_r", "short_term"):
        assert torch.equal(got[k], want[k]), k
    for k in ("d_ref", "dl5", "dr5"):
        _close(got[k], want[k], 1e-6, 0.0)
    xs = sc.obs_inputs(e.state)
    got = rtk.obs_all(*xs, **sc.obs_kw)
    assert torch.equal(got.view(torch.int32), rtk.obs_all(*xs, **sc.obs_kw, tile=0).view(torch.int32))
    want = rtk.obs_all_plain(*xs, **sc.obs_kw)
    far = [10 + 11 * k + 10 for k in range(sc.obs_kw["K"])]
    assert torch.equal(got[..., far] == 1.0, want[..., far] == 1.0)
    _close(got, want, 1e-6, 0.0)
