"""The port's env-axis sharding and learner (``vmas_tpu_torch/parallel/mesh.py``,
``learner.py``) and the sharded branches of PPO against the JAX package's, in
one process on the CPU:

* ``shard_state``'s choice, leaf by leaf, of what is sharded on the env
  axis and what is replicated, against the JAX package's on the same numpy
  trees (its 8-device CPU mesh), with the env axis given and inferred;
* ``make_train_step`` against the JAX package's from one injected
  simple_spread state with the JAX ``init_mlp`` parameters carried across
  (``interop.learner_params_from_numpy``), horizon 3: the loss to rtol
  1e-5 and the parameters to atol 1e-5;
* a plain-path train step on navigation (its Lidar in the graph) moves
  the parameters;
* the collectives: on a stand-in mesh of two ranks whose all-reduce sums a
  twin rank's equal values, the forward rollouts make none, a learner step
  exactly one bucket (and then equals the one-rank step bitwise), and a
  PPO update one per epoch for the advantage statistics, one per epoch for
  the gradients and one for the metrics.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import vmas_tpu
from vmas_tpu.parallel.learner import init_mlp as jax_init_mlp
from vmas_tpu.parallel.learner import make_train_step as jax_make_train_step
from vmas_tpu.parallel.mesh import env_mesh as jax_env_mesh
from vmas_tpu.parallel.mesh import shard_state as jax_shard_state
from vmas_tpu_torch import make_env
from vmas_tpu_torch.core.utils import tree_leaves, tree_map
from vmas_tpu_torch.interop import learner_params_from_numpy, learner_params_to_numpy, state_from_numpy
from vmas_tpu_torch.parallel import mesh as M
from vmas_tpu_torch.parallel import rollout_fn, rows_policy_rollout_fn, rows_rollout_fn, shard_state
from vmas_tpu_torch.parallel.learner import init_mlp, make_train_step
from vmas_tpu_torch.parallel.ppo import init_actor_critic, make_ppo_update, obs_dim_of
from vmas_tpu_torch.testing import deterministic_policy, mpe_state

torch.set_num_threads(1)


class StandInMesh:
    """A mesh of ``n`` ranks seen from rank ``rank``, for the code that only
    asks a mesh its size and rank (and, through a patched all-reduce, its
    group)."""

    def __init__(self, n, rank=0):
        self.n, self.rank = n, rank

    def size(self):
        return self.n

    def get_local_rank(self):
        return self.rank

    def get_group(self):
        return None


def _trees():
    z = lambda *s: np.arange(int(np.prod(s)), dtype=np.float32).reshape(s)
    return [
        ({"pos": z(8, 3, 2), "steps": z(8).astype(np.int32), "key": z(2).astype(np.uint32), "table": z(5, 8),
          "nested": {"a": z(8, 1), "scalar": np.float32(1.0)}, "agents": [z(8, 2), z(8, 4)]}, 8),
        ({"a": z(8), "b": z(16), "c": z(16, 3)}, None),  # the axis inferred: 16
        ({"b": z(16), "a": z(8)}, None),  # a tie: the first in flatten order (sorted keys), 8
        ({"pos": z(8, 3, 2), "steps": z(8), "key": z(2)}, None),
    ]


@pytest.mark.parametrize("case", range(4))
def test_shard_state_leaf_choice_matches_jax(case):
    tree, batch_dim = _trees()[case]
    jout = jax_shard_state(tree, jax_env_mesh(), batch_dim=batch_dim)
    want = [leaf.sharding.spec == P("env") for leaf in jax.tree.leaves(jout)]
    ttree = tree_map(torch.as_tensor, tree)
    B = M.env_axis_size(ttree, batch_dim)
    got = M.shard_state(ttree, StandInMesh(2, rank=1), batch_dim=batch_dim)
    sharded = [t.ndim > 0 and t.shape[0] == B // 2 and t.shape != s.shape
               for t, s in zip(tree_leaves(got), tree_leaves(ttree))]
    assert sharded == want and any(want) and not all(want)
    for t, s, sh in zip(tree_leaves(got), tree_leaves(ttree), sharded):
        assert torch.equal(t, s[B // 2:] if sh else s)
    # numpy leaves too, and the same choice
    np_got = M.shard_state(tree, StandInMesh(2, rank=1), batch_dim=batch_dim)
    assert [a.shape for a in tree_leaves(np_got)] == [tuple(t.shape) for t in tree_leaves(got)]


def test_shard_state_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="divide evenly"):
        shard_state({"x": torch.zeros(6)}, StandInMesh(4))


# -- the learner against the JAX package's ------------------------------------------

HORIZON = 3
LR = 1e-2


def test_train_step_matches_jax():
    env = make_env("simple_spread", num_envs=8, device="cpu", seed=0, grad_enabled=True)
    arrays = mpe_state(env, np.random.default_rng(21))
    env.state = state_from_numpy(env.world, arrays)
    jenv = vmas_tpu.make_env("simple_spread", num_envs=8, seed=0, grad_enabled=True)
    js = jenv.state.replace(**{k: jax.numpy.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")},
                            u=tuple(jax.numpy.asarray(x) for x in arrays["u"]),
                            scenario={**jenv.state.scenario,
                                      **{k: jax.numpy.asarray(v) for k, v in arrays["scenario"].items()}})
    obs_dim = env._observations(env.state)[0].shape[-1]
    jparams = jax_init_mlp(jax.random.PRNGKey(1), [obs_dim, 32, env.agents[0].action_size])
    jp, _, _, jloss = jax.jit(jax_make_train_step(jenv, horizon=HORIZON, lr=LR))(
        jparams, js, jenv.steps, jax.random.PRNGKey(2))

    np_params = jax.tree.map(np.asarray, jparams)
    params = learner_params_from_numpy(np_params, device="cpu")
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(learner_params_to_numpy(params), np_params) for k in a)
    tp, state, _, loss = make_train_step(env, horizon=HORIZON, lr=LR)(params, env.state, env.steps,
                                                                     torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    moved = 0.0
    for a, b, p0 in zip(learner_params_to_numpy(tp), jax.tree.map(np.asarray, jp), np_params):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0)
            moved = max(moved, float(np.abs(a[k] - p0[k]).max()))
    assert moved > 1e-4  # the step moved the parameters well beyond the tolerance
    assert not state.pos.requires_grad and all(not p[k].requires_grad for p in tp for k in p)


def test_train_step_moves_params_through_the_lidar():
    env = make_env("navigation", num_envs=4, device="cpu", seed=0, grad_enabled=True)
    obs_dim = env._observations(env.state)[0].shape[-1]
    params = init_mlp([obs_dim, 16, env.agents[0].action_size], generator=torch.Generator().manual_seed(0),
                      device="cpu")
    new, state, steps, loss = make_train_step(env, horizon=2, lr=1e-2)(params, env.state, env.steps,
                                                                      torch.Generator().manual_seed(1))
    assert torch.isfinite(loss) and int(steps[0]) == 2
    moved = max(float((a[k] - b[k]).abs().max()) for a, b in zip(new, params) for k in ("w", "b"))
    assert moved > 0 and all(bool(torch.isfinite(p[k]).all()) for p in new for k in p)
    with pytest.raises(ValueError, match="grad_enabled"):
        make_train_step(make_env("navigation", num_envs=4, device="cpu"))


# -- the collectives ------------------------------------------------------------------

@pytest.fixture
def twin_rank(monkeypatch):
    """A two-rank stand-in mesh whose all-reduce adds an equal twin rank's
    values (the tensor doubled, in place), counting the calls."""
    calls = []

    def all_reduce(t, op=None, group=None):
        calls.append(tuple(t.shape))
        return t.mul_(2)

    monkeypatch.setattr(M.dist, "all_reduce", all_reduce)
    return StandInMesh(2), calls


def test_forward_rollouts_make_no_collectives(twin_rank):
    mesh, calls = twin_rank
    env = make_env("transport", num_envs=4, device="cpu", seed=0, fused_physics=True)
    env.mesh = mesh
    c0 = M.collectives
    g = torch.Generator().manual_seed(0)
    rollout_fn(env, horizon=3)(env.state, env.steps, g)
    rows_rollout_fn(env, horizon=3)(env.state, env.steps, g)
    rows_policy_rollout_fn(env, deterministic_policy, 3)(env.state, env.steps, g)
    assert M.collectives == c0 and calls == []


def test_learner_step_is_one_bucket(twin_rank):
    mesh, calls = twin_rank
    env = make_env("simple_spread", num_envs=4, device="cpu", seed=0, grad_enabled=True)
    obs_dim = env._observations(env.state)[0].shape[-1]
    params = init_mlp([obs_dim, 8, 2], generator=torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(env, horizon=2, lr=1e-2)
    single = step(params, env.state, env.steps, torch.Generator().manual_seed(1))
    env.mesh = mesh
    c0 = M.collectives
    twin = step(params, env.state, env.steps, torch.Generator().manual_seed(1))
    n_params = sum(p[k].numel() for p in params for k in p)
    assert M.collectives - c0 == 1 and calls == [(n_params + 1,)]
    assert torch.equal(single[3], twin[3])
    assert all(torch.equal(a[k], b[k]) for a, b in zip(single[0], twin[0]) for k in ("w", "b"))


def test_ppo_update_collectives(twin_rank):
    mesh, calls = twin_rank
    env = make_env("transport", num_envs=4, device="cpu", seed=0, fused_physics=True)
    env.mesh = mesh
    model = init_actor_critic(obs_dim_of(env), 2, hidden=(8, 8), generator=torch.Generator().manual_seed(0),
                              device="cpu")
    update, make_opt = make_ppo_update(env, horizon=4, epochs=2, collect="rows")
    c0 = M.collectives
    _, _, metrics = update(model, make_opt(model), env.state, env.steps, torch.Generator().manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    assert M.collectives - c0 == 5
    assert sorted(calls) == sorted([(3,), (3,), (n_params + 1,), (n_params + 1,), (2,)])
    assert all(torch.isfinite(v) for v in metrics.values())


def test_env_mesh_without_a_gpu_raises(monkeypatch):
    """Without ``devices`` the mesh is CUDA's, as every entry point of the
    port defaults to the card: with no GPU it raises before any process
    group is made, and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not M.dist.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.env_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.env_mesh(devices=["cuda:0"], backend="gloo")
    assert not M.dist.is_initialized()


def test_env_mesh_and_distribute_on_one_rank():
    """Where no process group runs, env_mesh makes one of this rank alone
    (gloo for the CPU) and never switches its backend; distribute on one
    rank leaves the env as it is, with its mesh set."""
    assert not M.dist.is_initialized()
    try:
        mesh = M.env_mesh(devices=["cpu"])
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("env",) and M.dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="does not switch"):
            M.env_mesh(devices=["cpu"], backend="nccl")
        with pytest.raises(ValueError, match="ranks of the process group"):
            M.env_mesh(devices=["cpu"], n_devices=2)
        env = make_env("transport", num_envs=4, device="cpu", seed=0)
        state, steps = env.state, env.steps
        assert M.distribute(env) is env and env.mesh.size() == 1
        assert env.state is state and env.steps is steps and env.num_envs == 4
        with pytest.raises(ValueError, match="divide evenly"):
            M.distribute(make_env("transport", num_envs=3, device="cpu"), StandInMesh(2))
    finally:
        M.dist.destroy_process_group()
