"""The CUDA kernel of the fused step (vmas_tpu_torch/csrc/fused_step.cu)
against its plain PyTorch version, on the card.

The kernel has no CPU mode, so every test here needs a CUDA GPU: they carry
the ``gpu`` marker and skip without one. On a machine with a card and the
CUDA toolkit:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest`` keeps the repository's JAX test configuration out; these
tests import no JAX.) Tolerances as in chip_smoke.py: state rows atol 1e-5
rtol 1e-5, observation rows atol 2e-5, reward and shaping rows atol 2e-3.
"""

import pytest
import torch

from vmas_tpu_torch import make_env
from vmas_tpu_torch.core import fused as F

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
