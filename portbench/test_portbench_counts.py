"""The frozen counts behind the shares agree with the port's chip script's
arithmetic on a tiny world's shapes, and the actor-critic's FLOPs with
PyTorch's own count of its matmuls. Run from the repository's root:
``python -m pytest portbench -q``."""

from pathlib import Path

import pytest
import torch

from portbench import counts as C
from portbench import harness as H
from portbench.reference import physics as P
from portbench.reference import ppo as R

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("config", ["transport", "joint_passage"])
def test_k2_counts_agree_with_the_chip_script(config):
    import chip_smoke
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.core import fused as F

    B = 8
    cfg = H.load_module(ROOT / "portbench" / "configs" / f"{config}.py", f"count_cfg_{config}")
    env = make_env(config, num_envs=B, device="cpu", seed=3, fused_physics=True)
    fo, ks = env._fused_outputs, F._kernel_spec(env.world)
    rows = F.pack_carry(env.world, env.state, fo)
    spec = P.Spec(cfg.WORLD)
    tests, crossing = C.line_line_tests(spec, rows)
    ops = C.step_ops_per_env(spec, cfg.EMIT_OPS, cfg.N_OUT) * B + C.line_line_ops(spec, tests, crossing)
    assert ops == chip_smoke.kernel_ops(ks, rows, fo, rows_form=True)
    A, R_in = len(cfg.ACT_SLOTS), F.rows_layout(env.world, fo)
    assert C.rows_step_bytes(spec, len(cfg.CARRY_EXTRA_IDX), 2 * A, cfg.N_OUT, B) == (R_in + 2 * A + R_in
                                                                                      + fo.n_out) * B * 4
    assert C.bound_seconds(ops, 1)[0] == ops / chip_smoke.PEAK_F32


def test_actor_critic_flops_agree_with_torch():
    """One update's counted matmul FLOPs against torch's FlopCounterMode over
    the same passes: the policy per collection step, the values over T+1
    steps, and each epoch's forward and backward."""
    from torch.utils.flop_counter import FlopCounterMode

    obs_dim, act_dim, hidden, n, T, epochs = 11, 2, (16, 16), 12, 3, 2
    weights = R.make_weights(obs_dim, act_dim, hidden, torch.Generator().manual_seed(0), "cpu")
    model = R.load_weights(R.ActorCritic(obs_dim, act_dim, hidden, "cpu"), weights)
    x = torch.randn(n, obs_dim)
    batch = {"obs": torch.randn(T, n, obs_dim), "act": torch.rand(T, n, act_dim), "logp": torch.zeros(T, n),
             "adv": torch.randn(T, n), "ret": torch.randn(T, n)}
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            for _ in range(T):
                R.policy_dist(model, x)
            R.mlp(model.v, torch.randn(T + 1, n, obs_dim))
        for _ in range(epochs):
            R.ppo_loss(model, batch).backward()
    assert fc.get_total_flops() == C.ppo_update_flops(obs_dim, act_dim, hidden, n, T, epochs)
