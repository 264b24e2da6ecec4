"""The port's sharded run in two real processes (counterpart of
tests/test_multihost.py): two gloo ranks on the CPU, each started by
``parallel.mesh.spawn_ranks`` running ``vmas_tpu_torch.testing``'s
``multihost_worker`` (its log and its results in files, never pipes), held
against the same work in this process:

* from one injected global transport state (8 envs, 4 agents, fused),
  ``rows_policy_rollout_fn`` under a policy that draws nothing gives each
  rank the rows of its envs bitwise the single-process run's, with no
  collective;
* one learner step (horizon 2): the parameters bitwise equal on both ranks,
  and the single-process global-gradient step's within 1e-6, after exactly
  one all-reduce;
* a sharded ``fit`` (2 epochs) on each rank's half of one batch: equal on
  both ranks, and the single-process ``fit`` of the whole batch's within
  1e-6;
* a sharded checkpoint (npz with the rank in its name, and dcp with the rank
  in its keys) restored into a fresh distributed env, which keeps its mesh
  and replays the next 3 random-action steps bitwise.
"""

import numpy as np
import pytest
import torch

from vmas_tpu_torch import testing as T
from vmas_tpu_torch.parallel import rows_policy_rollout_fn
from vmas_tpu_torch.parallel.learner import make_train_step
from vmas_tpu_torch.parallel.mesh import spawn_ranks
from vmas_tpu_torch.parallel.ppo import fit

torch.set_num_threads(1)

NUM_ENVS = 8
HORIZON = 20
RANKS = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    spawn_ranks(RANKS, "vmas_tpu_torch.testing", ["--out", out, "--num_envs", NUM_ENVS, "--horizon", HORIZON],
                str(out), timeout=240)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]


def test_sharded_rollout_is_the_single_process_rollout(ranks):
    env = T.mh_env(NUM_ENVS, "cpu", fused_physics=True)
    state, _, traj = rows_policy_rollout_fn(env, T.deterministic_policy, HORIZON)(
        env.state, env.steps, torch.Generator().manual_seed(0))
    obs = torch.stack(traj["obs"])
    for r, res in enumerate(ranks):
        sl = slice(r * NUM_ENVS // RANKS, (r + 1) * NUM_ENVS // RANKS)
        assert int(res["num_envs"]) == NUM_ENVS // RANKS and int(res["collectives_rollout"]) == 0
        np.testing.assert_array_equal(res["rewards"], traj["rewards"][:, sl].numpy(), err_msg=f"rank {r}")
        np.testing.assert_array_equal(res["dones"], traj["dones"][:, sl].numpy())
        np.testing.assert_array_equal(res["obs"], obs[:, :, sl].numpy())
        np.testing.assert_array_equal(res["pos"], state.pos[sl].numpy())
        np.testing.assert_array_equal(res["vel"], state.vel[sl].numpy())
    assert (traj["rewards"] != 0).any()


def test_sharded_learner_step_is_the_global_step(ranks):
    env = T.mh_env(NUM_ENVS, "cpu", grad_enabled=True)
    params, _, _, loss = make_train_step(env, horizon=T.MH_LEARNER_HORIZON, lr=T.MH_LR)(
        T.mh_learner(env), env.state, env.steps, torch.Generator().manual_seed(0))
    flat = T._flat([t for layer in params for t in (layer["w"], layer["b"])])
    np.testing.assert_array_equal(ranks[0]["learner"], ranks[1]["learner"])
    for res in ranks:
        assert int(res["collectives_learner"]) == 1
        np.testing.assert_allclose(res["learner"], flat, atol=1e-6, rtol=0)
        np.testing.assert_allclose(float(res["loss"]), float(loss), rtol=1e-6)
    initial = T._flat([t for layer in T.mh_learner(env) for t in (layer["w"], layer["b"])])
    assert np.abs(flat - initial).max() > 1e-4


def test_sharded_fit_is_the_global_fit(ranks):
    batch, model, opt = T.mh_fit_batch(NUM_ENVS, 3, "cpu")
    initial = T._flat(model.parameters())
    fit(model, opt, batch, T.MH_FIT_EPOCHS)
    want = T._flat(model.parameters())
    np.testing.assert_array_equal(ranks[0]["fit"], ranks[1]["fit"])
    for res in ranks:
        np.testing.assert_allclose(res["fit"], want, atol=1e-6, rtol=0)
    assert np.abs(want - initial).max() > 1e-3


def test_sharded_checkpoint_round_trips(ranks):
    for res in ranks:
        for backend in ("npz", "dcp"):
            assert bool(res[f"resumed_{backend}"]) and bool(res[f"mesh_kept_{backend}"]), backend
