"""The port's PPO path (vmas_tpu_torch/parallel/ppo.py and the policy
rollouts of vmas_tpu_torch/parallel/rollout.py) against the JAX package's,
on the CPU, at transport with 16 envs and 3 agents and a horizon of 5.

The same weights (the JAX package's ``init_actor_critic``, carried across by
``interop.actor_critic_from_numpy``) and the same inputs, made from a seed
with numpy, go through the JAX function and its counterpart in the port:
the MLP, the Gaussian and its log-density, GAE, the loss and its gradients
(``jax.grad`` against autograd), and one Adam step on the same gradients
(optax against ``torch.optim.Adam``). JAX's ``gae``, ``loss_fn`` and ``fit``
are the closures of its ``make_ppo_update``, reached through the closure
cells of the function it returns.

Then the slice as a whole: a contact-rich JAX state injected into the port,
JAX's ``rows_policy_rollout_fn(policy_aux=True)`` replayed through the
port's (the port's policy returns JAX's raw sample at step t and computes
its own log-density from its own observations: the random streams cannot
match), and the port's batch build and ``fit`` on its trajectory against
what JAX's own ``update`` computed internally on JAX's trajectory (its
advantages, returns and batch, recorded by ``jax.debug.callback`` from
wrappers of its ``gae`` and ``fit`` cells) and against its parameters after
2 epochs. JAX's Pallas rows kernel runs in interpret mode, as in its own
tests; each JAX program compiles once per file.

Then the port alone (tests/test_ppo.py and tests/test_rows_rollout.py's
invariants): the rows policy rollout bitwise the ``env.step`` policy
rollout, the observation/action alignment, training at ``collect`` "rows"
and "step" and in bf16, evaluation, ``reset_every``, ``autoreset``, the
choice of path in ``rollout()``, and the weights' round trip.

Tolerances: the f32 MLP, mean and log-density atol 1e-5 rtol 1e-5; the
bf16 MLP at a quarter of JAX's own bf16-f32 gap in each trunk (bf16 keeps 8
bits: XLA and torch may round a product or a tanh differently, but an f32
trunk must not pass); GAE
atol 1e-5 rtol 1e-5; the loss rtol 1e-5 and its gradients atol 1e-6 rtol 1e-4; one Adam
step atol 1e-7 rtol 1e-6 (an ulp of the parameter); the rollout replay
at the transport parity tests' tolerances (observations atol 2e-5 rtol
1e-5, rewards atol 2e-3, dones equal) and the replayed log-density atol
1e-5; the batch's advantages and returns atol 1e-4 (sums of rewards and
values, each held far tighter than the rewards' 2e-3 here, as the
replayed rewards agree to a few 1e-6); the parameters after ``fit`` atol
5e-6 (Adam moves each parameter by up to 3e-4 a step).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vmas_tpu
from test_torch_fused import contact_rich, jax_state
from vmas_tpu.parallel import ppo as JP
from vmas_tpu.parallel.rollout import rows_policy_rollout_fn as jax_rows_policy_rollout_fn
from vmas_tpu_torch import make_env, profiling, testing
from vmas_tpu_torch.interop import actor_critic_from_numpy, actor_critic_to_numpy, state_from_numpy
from vmas_tpu_torch.parallel import ppo as TP

# the package exports the function ``rollout``, which shadows its module
TR = sys.modules["vmas_tpu_torch.parallel.rollout"]

torch.set_num_threads(1)

B, A, H, EPOCHS = 16, 3, 5, 2
F32 = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cells(fn):
    return dict(zip(fn.__code__.co_freevars, fn.__closure__))


def _env(**kw):
    kw.setdefault("n_agents", A)
    kw.setdefault("fused_physics", True)
    return make_env("transport", kw.pop("num_envs", B), device="cpu", seed=0, **kw)


def _model(env, seed=0):
    return TP.init_actor_critic(TP.obs_dim_of(env), 2, generator=torch.Generator().manual_seed(seed), device="cpu")


@pytest.fixture(scope="module")
def jx():
    """The JAX side, run once: its env, weights, contact-rich state, its rows
    policy rollout, and its rows update with its internals recorded."""
    jenv = vmas_tpu.make_env("transport", B, seed=0, n_agents=A, fused_physics=True)
    params = JP.init_actor_critic(jax.random.PRNGKey(0), JP.obs_dim_of(jenv), 2)
    arrays = contact_rich(jenv, seed=3)
    state, steps = jax_state(jenv, arrays), jenv.steps
    key = jax.random.PRNGKey(5)
    pol = JP.make_gaussian_policy(jenv)
    run = jax.jit(jax_rows_policy_rollout_fn(jenv, lambda o, k: pol(params, o, k), H, policy_aux=True))
    _, _, traj = run(state, steps, key)

    update, opt = JP.make_ppo_update(jenv, horizon=H, collect="rows", epochs=EPOCHS)
    cells = _cells(update)
    gae, fit = cells["gae"].cell_contents, cells["fit"].cell_contents
    rec = {}

    def gae_spy(rews, dones, values):
        advs, rets = gae(rews, dones, values)
        jax.debug.callback(lambda v, a, r: rec.update(values=v, adv=a, ret=r), values, advs, rets)
        return advs, rets

    def fit_spy(p, o, flat):
        jax.debug.callback(lambda f: rec.update(flat=f), flat)
        return fit(p, o, flat)

    cells["gae"].cell_contents, cells["fit"].cell_contents = gae_spy, fit_spy
    p_after, _, _, _, metrics = jax.jit(update)(params, opt.init(params), state, steps, key)
    jax.block_until_ready(p_after)
    return dict(
        jenv=jenv, params=params, arrays=arrays, traj=_np(traj), rec=_np(rec), p_after=_np(p_after),
        loss=float(metrics["loss"]), gae=gae, loss_fn=_cells(fit)["loss_fn"].cell_contents,
    )


@pytest.fixture(scope="module")
def batch_np():
    """A random training batch [T, B, A, ...] as numpy."""
    rng = np.random.default_rng(0)
    T, O = 4, 4 + 7
    return {
        "obs": rng.normal(0, 1, (T, B, A, O)).astype(np.float32),
        "act": rng.uniform(-1, 1, (T, B, A, 2)).astype(np.float32),
        "logp": rng.normal(-1, 0.3, (T, B, A)).astype(np.float32),
        "adv": rng.normal(0, 1, (T, B, A)).astype(np.float32),
        "ret": rng.normal(0, 1, (T, B, A)).astype(np.float32),
    }


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# module parity against the JAX package
# ---------------------------------------------------------------------------


def test_mlp_policy_dist_logp_f32(jx, batch_np):
    model = actor_critic_from_numpy(_np(jx["params"]), device="cpu")
    obs = batch_np["obs"]
    for trunk in ("pi", "v"):
        want = np.asarray(JP._mlp(jx["params"][trunk], jnp.asarray(obs)))
        got = TP._mlp(getattr(model, trunk), torch.as_tensor(obs)).detach().numpy()
        np.testing.assert_allclose(got, want, **F32, err_msg=trunk)
    jm, js = JP.policy_dist(jx["params"], jnp.asarray(obs))
    tm, ts = TP.policy_dist(model, torch.as_tensor(obs))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), **F32)
    np.testing.assert_array_equal(ts.detach().numpy(), np.asarray(js))
    act = batch_np["act"]
    want = np.asarray(JP.gaussian_logp(jm, js, jnp.asarray(act)))
    got = TP.gaussian_logp(tm, ts, torch.as_tensor(act)).detach().numpy()
    np.testing.assert_allclose(got, want, **F32)


def test_mlp_bf16(jx, batch_np):
    """The bf16 MLP against JAX's, held at a quarter of JAX's own bf16-f32
    gap in each trunk (pi 1.4e-5, v 1.6e-3 here), so that an f32 trunk,
    which sits the whole gap away, fails."""
    model = actor_critic_from_numpy(_np(jx["params"]), device="cpu")
    obs = batch_np["obs"]
    for trunk in ("pi", "v"):
        want = np.asarray(JP._mlp(jx["params"][trunk], jnp.asarray(obs), jnp.bfloat16))
        want_f32 = np.asarray(JP._mlp(jx["params"][trunk], jnp.asarray(obs)))
        got = TP._mlp(getattr(model, trunk), torch.as_tensor(obs), torch.bfloat16)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        gap = np.abs(want - want_f32).max()
        assert gap > 0, trunk
        np.testing.assert_allclose(got.detach().numpy(), want, atol=gap / 4, rtol=0, err_msg=trunk)


def test_gae_matches_jax(jx):
    rng = np.random.default_rng(1)
    T = 7
    rews = rng.normal(0, 1, (T, B, A)).astype(np.float32)
    dones = rng.uniform(size=(T, B)) < 0.2
    values = rng.normal(0, 1, (T + 1, B, A)).astype(np.float32)
    ja, jr = jx["gae"](jnp.asarray(rews), jnp.asarray(dones), jnp.asarray(values))
    ta, tr = TP.gae(torch.as_tensor(rews), torch.as_tensor(dones), torch.as_tensor(values))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **F32)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **F32)
    assert dones.any()


def test_loss_and_grads_match_jax(jx, batch_np):
    params = jx["params"]
    (jloss, (jpg, jvf)), jg = jax.value_and_grad(jx["loss_fn"], has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch_np.items()}
    )
    model = actor_critic_from_numpy(_np(params), device="cpu")
    loss, (pg, vf) = TP.ppo_loss(model, _torch_batch(batch_np))
    loss.backward()
    for got, want in ((loss, jloss), (pg, jpg), (vf, jvf)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    grads = {
        "pi": [{"w": layer.weight.grad.numpy().T, "b": layer.bias.grad.numpy()} for layer in model.pi],
        "v": [{"w": layer.weight.grad.numpy().T, "b": layer.bias.grad.numpy()} for layer in model.v],
        "log_std": model.log_std.grad.numpy(),
    }
    flat_t, _ = jax.tree_util.tree_flatten(grads)
    flat_j, _ = jax.tree_util.tree_flatten(_np(jg))
    assert len(flat_t) == len(flat_j) == 13
    for got, want in zip(flat_t, flat_j):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4)
    assert all(np.abs(g).max() > 0 for g in flat_j)


def test_adam_steps_match_optax(jx):
    """Three Adam steps on the same numpy gradients: optax.adam against
    torch.optim.Adam (betas 0.9/0.999, eps 1e-8), the same formula."""
    rng = np.random.default_rng(2)
    params = _np(jx["params"])
    opt = optax.adam(3e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = opt.init(jp)
    model = actor_critic_from_numpy(params, device="cpu")
    topt = torch.optim.Adam(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(3):
        # gradients of every magnitude, a few near eps
        g = jax.tree_util.tree_map(
            lambda p: (rng.normal(0, 1, p.shape) * 10.0 ** rng.integers(-9, 1, p.shape)).astype(np.float32),
            params,
        )
        upd, js = opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for layers, gs in ((model.pi, g["pi"]), (model.v, g["v"])):
            for layer, gl in zip(layers, gs):
                layer.weight.grad = torch.as_tensor(gl["w"].T.copy())
                layer.bias.grad = torch.as_tensor(gl["b"])
        model.log_std.grad = torch.as_tensor(g["log_std"])
        topt.step()
    got = jax.tree_util.tree_leaves(actor_critic_to_numpy(model))
    want = jax.tree_util.tree_leaves(_np(jp))
    moved = 0
    for a, b, p0 in zip(got, want, jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=1e-6)
        moved += int((a != p0).sum())
    assert moved > 0


# ---------------------------------------------------------------------------
# the slice as a whole against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_replay(jx):
    """The port's rows policy rollout from the injected JAX state, replaying
    JAX's raw samples, with the JAX weights."""
    env = _env()
    model = actor_critic_from_numpy(_np(jx["params"]), device="cpu")
    raw_j = torch.tensor(jx["traj"]["policy_aux"]["raw"])  # [T, B, A, 2]
    ranges = TP._ranges(env)
    t = [0]

    def replay(obs, generator):
        mean, std = TP.policy_dist(model, torch.stack(obs, dim=1))
        raw = raw_j[t[0]]
        t[0] += 1
        scaled = raw * ranges
        return tuple(scaled[:, i] for i in range(A)), {"raw": raw, "logp": TP.gaussian_logp(mean, std, raw)}

    state = state_from_numpy(env.world, jx["arrays"])
    run = TR.rows_policy_rollout_fn(env, replay, H, policy_aux=True)
    _, _, traj = run(state, env.steps, torch.Generator().manual_seed(0))
    return env, model, traj


def test_rows_policy_rollout_replays_jax(jx, port_replay):
    _, _, traj = port_replay
    want = jx["traj"]
    np.testing.assert_array_equal(traj["dones"].numpy(), want["dones"])
    np.testing.assert_allclose(traj["rewards"].numpy(), want["rewards"], atol=2e-3)
    for got, w in zip(traj["obs0"], want["obs0"]):
        np.testing.assert_allclose(got.numpy(), w, atol=2e-5, rtol=1e-5)
    for got, w in zip(traj["obs"], want["obs"]):
        np.testing.assert_allclose(got.numpy(), w, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(traj["policy_aux"]["logp"].numpy(), want["policy_aux"]["logp"], atol=1e-5)
    # not vacuous: the packages were pushed, so the rewards are shaped
    assert np.abs(want["rewards"]).max() > 1e-3


def test_rows_batch_and_fit_match_jax_update(jx, port_replay):
    """The port's batch build and fit on its replayed trajectory against
    JAX's update on its own trajectory (same key: the same samples)."""
    env, _, traj = port_replay
    rec = jx["rec"]
    np.testing.assert_array_equal(rec["flat"]["act"], jx["traj"]["policy_aux"]["raw"])
    model = actor_critic_from_numpy(_np(jx["params"]), device="cpu")
    batch = TP.rows_batch(model, traj)
    np.testing.assert_allclose(batch["obs"].numpy(), rec["flat"]["obs"], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(batch["logp"].numpy(), rec["flat"]["logp"], atol=1e-5)
    np.testing.assert_allclose(batch["adv"].numpy(), rec["adv"], atol=1e-4)
    np.testing.assert_allclose(batch["ret"].numpy(), rec["ret"], atol=1e-4)
    np.testing.assert_array_equal(rec["flat"]["adv"], rec["adv"])
    _, make_opt = TP.make_ppo_update(env, horizon=H, collect="rows", epochs=EPOCHS)
    loss = TP.fit(model, make_opt(model), batch, EPOCHS)
    np.testing.assert_allclose(float(loss), jx["loss"], rtol=1e-3, atol=1e-5)
    got = jax.tree_util.tree_leaves(actor_critic_to_numpy(model))
    want = jax.tree_util.tree_leaves(jx["p_after"])
    for a, b, p0 in zip(got, want, jax.tree_util.tree_leaves(_np(jx["params"]))):
        np.testing.assert_allclose(a, b, atol=5e-6)
        assert (b != p0).any()


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------


def _assert_same_traj(ta, tb):
    assert torch.equal(ta["rewards"], tb["rewards"])
    assert torch.equal(ta["dones"], tb["dones"])
    for a, b in zip(ta["obs"], tb["obs"]):
        assert torch.equal(a, b)


def test_rows_policy_rollout_equals_step_policy_rollout():
    """The same policy and generator seed through rollout_fn (env.step, the
    fused step) and rows_policy_rollout_fn (the rows step): bitwise."""
    env = _env()
    s0 = state_from_numpy(env.world, contact_rich(env, seed=7))
    model = _model(env)
    pol = TP.make_gaussian_policy(env)
    policy = lambda obs, g: pol(model, obs, g)
    sa, sta, ta = TR.rollout_fn(env, policy, 6, policy_aux=True)(s0, env.steps, torch.Generator().manual_seed(3))
    sb, stb, tb = TR.rows_policy_rollout_fn(env, policy, 6, policy_aux=True)(
        s0, env.steps, torch.Generator().manual_seed(3))
    _assert_same_traj(ta, tb)
    for k in ("raw", "logp"):
        assert torch.equal(ta["policy_aux"][k], tb["policy_aux"][k]), k
    assert tb["policy_aux"]["raw"].shape == (6, B, A, 2) and tb["policy_aux"]["logp"].shape == (6, B, A)
    for a, b in zip(ta["obs0"], tb["obs0"]):
        assert torch.equal(a, b)
    for name in ("pos", "vel", "rot", "ang_vel", "force", "torque"):
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    for ua, ub in zip(sa.u, sb.u):
        assert torch.equal(ua, ub)
    for k in sa.scenario:
        assert torch.equal(sa.scenario[k], sb.scenario[k]), k
    assert torch.equal(sta, stb)
    assert bool((tb["rewards"] != 0).any())


def test_policy_aux_alignment():
    """The action recorded at step t was sampled from the observations
    emitted at t-1 (obs0 at t=0): recomputing the Gaussian from the shifted
    observations gives the recorded log-density, and from the unshifted
    ones it does not."""
    env = _env()
    s0 = state_from_numpy(env.world, contact_rich(env, seed=8))
    model = _model(env)
    pol = TP.make_gaussian_policy(env)
    _, _, traj = TR.rows_policy_rollout_fn(env, lambda o, g: pol(model, o, g), 6, policy_aux=True)(
        s0, env.steps, torch.Generator().manual_seed(7))
    obs_emitted = torch.stack(traj["obs"], dim=2)
    obs0 = torch.stack(traj["obs0"], dim=1)
    obs_act = torch.cat([obs0[None], obs_emitted[:-1]])
    with torch.no_grad():
        logp = TP.gaussian_logp(*TP.policy_dist(model, obs_act), traj["policy_aux"]["raw"])
        logp_w = TP.gaussian_logp(*TP.policy_dist(model, obs_emitted), traj["policy_aux"]["raw"])
    err_right = float((logp - traj["policy_aux"]["logp"]).abs().max())
    err_wrong = float((logp_w - traj["policy_aux"]["logp"]).abs().max())
    assert err_right < 1e-5
    assert err_wrong > 5 * max(err_right, 1e-6)
    assert torch.equal(TP.rows_batch(model, traj)["obs"], obs_act)


@pytest.mark.parametrize("collect,dtype", [("rows", None), ("step", None), ("rows", torch.bfloat16)])
def test_ppo_update_trains(collect, dtype):
    env = _env()
    model = _model(env)
    update, make_opt = TP.make_ppo_update(env, horizon=4, collect=collect, epochs=2, compute_dtype=dtype)
    opt = make_opt(model)
    p0 = [p.detach().clone() for p in model.parameters()]
    state, steps, gen = env.state, env.steps, torch.Generator().manual_seed(1)
    for _ in range(2):
        state, steps, metrics = update(model, opt, state, steps, gen)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert all(not torch.equal(p, q) for p, q in zip(model.parameters(), p0))
    assert bool(torch.isfinite(metrics["loss"])) and 0 <= float(metrics["episode_done_frac"]) <= 1
    assert bool((steps == 8).all()) if collect == "rows" else bool((steps <= 8).all())


def test_ppo_rows_reset_every():
    """Episodic rows PPO: the update runs with reset_every, and the
    recorded dones mark every boundary."""
    env = _env()
    model = _model(env)
    update, make_opt = TP.make_ppo_update(env, horizon=4, collect="rows", epochs=1, reset_every=2)
    _, steps, metrics = update(model, make_opt(model), env.state, env.steps, torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(metrics["loss"]))
    assert float(metrics["episode_done_frac"]) >= 0.5
    assert bool((steps == 0).all())


@pytest.mark.parametrize("reset_every", [None, 2])
def test_update_built_once_equals_the_collection_rebuilt_per_call(reset_every):
    """``make_ppo_update`` builds its rows collection once and hands it the
    model on each call: 3 updates equal, bitwise, 3 whose collection is
    rebuilt per call around a closure over the model
    (``testing.rebuilt_ppo_update``): each trajectory, state, metric and
    the parameters after each update."""
    env = _env(num_envs=8)
    update, make_opt = TP.make_ppo_update(env, horizon=4, collect="rows", epochs=2, reset_every=reset_every)
    rebuilt = testing.rebuilt_ppo_update(env, 4, 2, reset_every=reset_every)
    sides = []
    for fn in (update, rebuilt):
        model = _model(env)
        sides.append(testing.ppo_updates(fn, model, make_opt(model), env.state, env.steps, 3, seed=11))
    for got, want in zip(*sides):
        assert testing.tensors_equal(got, want)
    assert not testing.tensors_equal(sides[0][0]["params"], sides[0][2]["params"])


def test_cpu_update_runs_the_eager_loop():
    """On the CPU the collection's steps run eagerly: each update records
    its policy steps and launches, and no capture or replay."""
    env = _env(num_envs=8)
    update, make_opt = TP.make_ppo_update(env, horizon=4, collect="rows", epochs=1)
    model = _model(env)
    profiling.reset()
    profiling.enable()
    try:
        testing.ppo_updates(update, model, make_opt(model), env.state, env.steps, 2, seed=3)
        s = profiling.summary()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert s["vmas.rows.policy_step"]["count"] == 8 and s["vmas.rows.launch"]["count"] == 8
    assert "vmas.rows.capture" not in s and "vmas.rows.replay" not in s


def test_evaluate_runs():
    env = _env()
    _, steps, metrics = TP.make_evaluate(env, horizon=4)(_model(env), env.state, env.steps, torch.Generator())
    assert bool(torch.isfinite(metrics["mean_reward"]))
    assert 0.0 <= float(metrics["episode_done_frac"]) <= 1.0
    assert bool((steps == 4).all())


def _chunked_step_rollout(env, policy, horizon, every, state, steps, gen):
    """rollout_fn run chunk by chunk with a full reset after each chunk:
    what reset_every must replay."""
    parts = []
    for _ in range(horizon // every):
        state, steps, traj = TR.rollout_fn(env, policy, every)(state, steps, gen)
        state, steps, _, _, _, _ = env._reset_fn(state, steps, gen, None)
        parts.append(traj)
    return state, steps, parts


@pytest.mark.parametrize("with_policy", [False, True])
def test_rows_reset_every(with_policy):
    """reset_every against rollout_fn chunk by chunk with full resets:
    the same trajectory but at each boundary step, whose observations are
    the post-reset ones and whose dones are all True."""
    env = _env()
    s0 = state_from_numpy(env.world, contact_rich(env, seed=9))
    model = _model(env)
    pol = TP.make_gaussian_policy(env)
    policy = (lambda o, g: pol(model, o, g)[0]) if with_policy else None
    rows = (TR.rows_policy_rollout_fn(env, policy, 6, reset_every=3) if with_policy
            else TR.rows_rollout_fn(env, 6, reset_every=3))
    sb, stb, tb = rows(s0, env.steps, torch.Generator().manual_seed(4))
    sa, sta, parts = _chunked_step_rollout(env, policy, 6, 3, s0, env.steps, torch.Generator().manual_seed(4))
    assert tb["dones"].shape == (6, B) and bool(tb["dones"][[2, 5]].all())
    for c, part in enumerate(parts):
        rows_c = slice(3 * c, 3 * c + 2)
        assert torch.equal(tb["rewards"][3 * c:3 * c + 3], part["rewards"])
        assert torch.equal(tb["dones"][rows_c], part["dones"][:2])
        for a, b in zip(tb["obs"], part["obs"]):
            assert torch.equal(a[rows_c], b[:2])
            assert not torch.equal(a[3 * c + 2], b[2])  # the boundary: post-reset
    # the last boundary's observations are those of the final (reset) state
    for a, b in zip(tb["obs"], env._observations(sb)):
        assert torch.equal(a[-1], b)
    assert torch.equal(sa.pos, sb.pos) and torch.equal(sta, stb) and bool((stb == 0).all())


def test_rollout_fn_autoreset():
    """autoreset resets exactly the envs that finished: with max_steps 3
    and staggered step counters, each env truncates on its own step; the
    others' trajectories are those of the rollout without autoreset."""
    env = _env(max_steps=3)
    s0 = env.state  # after a reset: no package on its goal, so no env terminates
    st0 = (torch.arange(B, dtype=torch.int32) % 3)
    W = torch.as_tensor(np.random.default_rng(3).normal(0, 0.3, (11, 2)), dtype=torch.float32)
    policy = lambda obs, g: tuple(torch.tanh(o @ W) for o in obs)
    sa, sta, ta = TR.rollout_fn(env, policy, 4, autoreset=True)(s0, st0, torch.Generator().manual_seed(2))
    sb, stb, tb = TR.rollout_fn(env, policy, 4)(s0, st0, torch.Generator().manual_seed(2))
    # env b truncates at step t where st0[b] + t + 1 == 3, then every 3 steps
    want_done = torch.stack([(st0 + t + 1) % 3 == 0 for t in range(4)])
    assert torch.equal(ta["dones"], want_done)
    assert torch.equal(sta, (st0 + 4) % 3)
    # the envs that never finished (none here reach 3 before the first
    # done) match the plain rollout up to their first done step
    first = want_done.int().argmax(dim=0)
    for t in range(4):
        live = first > t
        for oa, ob in zip(ta["obs"], tb["obs"]):
            assert torch.equal(oa[t][live], ob[t][live])
        done = want_done[t]
        for oa, ob in zip(ta["obs"], tb["obs"]):
            assert not torch.equal(oa[t][done], ob[t][done])  # post-reset observations
    # at the last step the recorded observations of the envs that finished
    # are those of the final state
    last = want_done[-1]
    for oa, o_fin in zip(ta["obs"], env._observations(sa)):
        assert torch.equal(oa[-1][last], o_fin[last])


def test_rollout_picks_path(monkeypatch):
    """rollout() takes the rows paths on rows-eligible transport (the same
    trajectory as rollout_fn) and rollout_fn where ineligible; it writes the
    final state back to the env."""
    called = []
    for name in ("rollout_fn", "rows_rollout_fn", "rows_policy_rollout_fn"):
        real = getattr(TR, name)
        monkeypatch.setattr(TR, name, lambda *a, _n=name, _r=real, **k: called.append(_n) or _r(*a, **k))
    env = _env()
    s0, st0 = env.state, env.steps
    traj = TR.rollout(env, horizon=3, generator=torch.Generator().manual_seed(5))
    _, _, ref = TR.rollout_fn(env, horizon=3)(s0, st0, torch.Generator().manual_seed(5))
    _assert_same_traj(traj, ref)
    assert bool((env.steps == 3).all()) and not torch.equal(env.state.pos, s0.pos)
    TR.rollout(env, lambda obs, g: tuple(torch.zeros(B, 2) for _ in obs), horizon=2)
    plain = _env(fused_physics=False)
    TR.rollout(plain, horizon=2)
    assert called == ["rows_rollout_fn", "rollout_fn", "rows_policy_rollout_fn", "rollout_fn"]


def test_weights_round_trip(jx):
    params = _np(jx["params"])
    model = actor_critic_from_numpy(params, device="cpu")
    back = actor_critic_to_numpy(model)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [layer.weight.shape for layer in model.pi] == [(128, 11), (128, 128), (2, 128)]


def test_init_law():
    """init_actor_critic follows the JAX package's law: N(0, 1) * scale /
    sqrt(fan_in), scale 0.01 on the policy head, biases 0, log_std -0.5."""
    model = TP.init_actor_critic(64, 2, hidden=(256, 256), generator=torch.Generator().manual_seed(0), device="cpu")
    for layers in (model.pi, model.v):
        for k, layer in enumerate(layers):
            scale = 0.01 if layers is model.pi and k == len(layers) - 1 else 1.0
            want = scale / np.sqrt(layer.in_features)
            assert abs(float(layer.weight.detach().std()) / want - 1) < 0.15
            assert not layer.bias.any()
    assert torch.equal(model.log_std, torch.full((2,), -0.5))

