"""Runner of PPO training: the program's ``make_ppo_update`` (collection
through ``rows_policy_rollout_fn``, the batch with values and GAE, full-batch
epochs of ``fit``), updates back to back on one model and optimizer.

Traffic parameters: ``metric`` (the name of the end-to-end rate it
reports), ``horizon``, ``epochs``, ``lr``, ``hidden``, ``compute_dtype``
(the networks' hidden activations: ``bfloat16``, the one type the
reference follows), ``check_updates`` (the updates of set-up, which the
reference follows), ``trace_updates`` (updates of each of the traced run's
stretches).

The check is the training one: set-up builds the model, the optimizer and
the state from the seed and takes the first updates through ``update``
itself; the reference follows those updates from the same inputs. Compared
are each update's loss, each leaf's first gradient as Adam got it (from its
first moment after one step), and each leaf's change after the updates.
"""

from __future__ import annotations

import statistics
import sys
import time

from portbench import counts as C
from portbench import harness as H

BETA1 = 0.9


def _dtype(name):
    import torch

    return {"bfloat16": torch.bfloat16}[name]


def _first_moment_hook(store):
    """An optimizer post-step hook that records, once, each parameter's
    gradient as Adam took it: its first moment after the first step over
    (1 - beta1)."""
    import torch

    def hook(optimizer, args, kwargs):
        if store:
            return
        for group in optimizer.param_groups:
            for p in group["params"]:
                store[id(p)] = float(torch.linalg.vector_norm(optimizer.state[p]["exp_avg"] / (1 - BETA1)))

    return hook


def _named(model, by_id):
    """Per parameter name, its entry of ``by_id``; NaN where the optimizer
    took no step that recorded it."""
    return {name: by_id.get(id(p), float("nan")) for name, p in model.named_parameters()}


def _changes(model, weights):
    import torch

    return {n: float(torch.linalg.vector_norm(p.detach() - weights[n])) for n, p in model.named_parameters()}


def reference_updates(cell, init, weights, run_seed, device, phys_dtype=None, mlp_dtype=None):
    """The reference's first ``check_updates`` updates from the benchmark's
    inputs -> (losses, first gradient norm per leaf, change norm per leaf).
    ``phys_dtype`` and ``mlp_dtype`` lower its precision for the control."""
    import torch

    from portbench.reference import ppo as R
    from portbench.reference.physics import Spec

    tr, cfg = cell.traffic, cell.reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = Spec(cfg.WORLD, phys_dtype or torch.float32)
    model = R.load_weights(R.ActorCritic(weights["pi.0.weight"].shape[1], weights["log_std"].shape[0],
                                         tr["hidden"], device), weights)
    opt = R.make_optimizer(model, tr["lr"])
    first = {}
    handle = opt.register_step_post_hook(_first_moment_hook(first))
    gen = torch.Generator(device=device).manual_seed(run_seed)
    carry = cfg.state_rows(init, cfg.scratch_rows(init))
    obs = cfg.observations(init)
    losses = []
    for _ in range(tr["check_updates"]):
        carry, obs, loss = R.update(cfg, spec, model, opt, carry, obs, gen, tr["horizon"], tr["epochs"],
                                    mlp_dtype or _dtype(tr["compute_dtype"]))
        losses.append(float(loss))
        handle.remove()
    return losses, _named(model, first), _changes(model, weights)


def compare(got, want):
    """The compared numbers: the largest relative gap of an update's loss;
    and by the worst leaf, the gap between the program's norm and the
    reference's of the first gradient, and of the change after the
    updates, each over the larger of the reference's norm of that leaf and
    of the median leaf. Leaves whose first gradient in the reference is
    under a thousandth of the median leaf's move by round-off alone and are
    left out of the change."""
    (gl, gg, gc), (wl, wg, wc) = got, want
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(gl, wl))
    med_g = statistics.median(wg.values())
    med_c = statistics.median(wc.values())
    grad_gap = max(abs(gg[k] - wg[k]) / max(wg[k], med_g) for k in wg)
    moving = [k for k in wc if wg[k] >= 1e-3 * med_g]
    change_gap = max(abs(gc[k] - wc[k]) / max(wc[k], med_c) for k in moving)
    print(f"leaves in the change: {len(moving)} of {len(wc)}; the smallest first gradient is "
          f"{min(wg.values()) / med_g:.4g} of the median leaf's", file=sys.stderr, flush=True)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def setup_program(cell, seed, device):
    """The program's environment, model, optimizer, update and state from
    the seed, and the benchmark's inputs (initial state, weights)."""
    import torch

    from vmas_tpu_torch.parallel import make_ppo_update, obs_dim_of
    from vmas_tpu_torch.parallel.ppo import ActorCritic

    from portbench.reference.ppo import load_weights, make_weights

    tr, cfg = cell.traffic, cell.reference
    s_init, s_run = H.seeds(seed)
    env, make_env_s = H.make_program_env(cell, device)
    g_init = torch.Generator(device=device).manual_seed(s_init)
    init = cfg.initial_state(cell.num_envs, g_init, device)
    obs_dim, act_dim = obs_dim_of(env), env.agents[0].action_size
    weights = make_weights(obs_dim, act_dim, tr["hidden"], g_init, device)
    model = load_weights(ActorCritic(obs_dim, act_dim, tuple(tr["hidden"]), device=device), weights)
    update, make_optimizer = make_ppo_update(env, horizon=tr["horizon"], lr=tr["lr"], epochs=tr["epochs"],
                                             collect="rows", compute_dtype=_dtype(tr["compute_dtype"]))
    gen = torch.Generator(device=device).manual_seed(s_run)
    return dict(env=env, make_env_s=make_env_s, init=init, weights=weights, model=model,
                opt=make_optimizer(model), update=update, gen=gen, state=H.program_state(env, init),
                steps=env.steps, s_run=s_run, obs_dim=obs_dim, act_dim=act_dim)


def first_updates(p, n):
    """The program's first ``n`` updates -> (losses, first gradient norm per
    leaf, change norm per leaf)."""
    first = {}
    handle = p["opt"].register_step_post_hook(_first_moment_hook(first))
    losses = []
    for _ in range(n):
        p["state"], p["steps"], m = p["update"](p["model"], p["opt"], p["state"], p["steps"], p["gen"])
        losses.append(m["loss"])
        handle.remove()
    return [float(x) for x in losses], _named(p["model"], first), _changes(p["model"], p["weights"])


def run(cell, seed, seconds, trace, device, t_start):
    import torch

    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.parallel import make_gaussian_policy, rows_policy_rollout_fn
    from vmas_tpu_torch.parallel import ppo as PP

    tr, B, T = cell.traffic, cell.num_envs, cell.traffic["horizon"]
    t_env = time.perf_counter()
    p = setup_program(cell, seed, device)
    t_upd = time.perf_counter()
    got = first_updates(p, tr["check_updates"])
    H.sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: start to make_env {t_env - t_start:.3f}, make_env {p['make_env_s']:.3f}, "
          f"inputs and model {t_upd - t_env - p['make_env_s']:.3f}, {tr['check_updates']} updates "
          f"{time.perf_counter() - t_upd:.3f}", file=sys.stderr, flush=True)
    readings, e2e, breakdown = {"kind": "ppo", "make_env_s": p["make_env_s"]}, {}, None

    def one_update():
        p["state"], p["steps"], _ = p["update"](p["model"], p["opt"], p["state"], p["steps"], p["gen"])

    if not trace:
        n, window_s = H.window(one_update, seconds, device)
        e2e = {tr["metric"]: B * T * n / window_s, "setup_s": setup_s}
        print(f"window: {n} updates of {T} steps x {B} envs in {window_s:.6f} s", file=sys.stderr, flush=True)
    else:
        n = tr["trace_updates"]
        # an update's time: CUDA events around the window's own call
        update_s = []
        for _ in range(n):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            one_update()
            ev[1].record()
            ev[1].synchronize()
            update_s.append(ev[0].elapsed_time(ev[1]) / 1e3)
        # its split: the public calls ``update`` makes, in its order
        # (parallel/ppo.py, make_ppo_update with collect="rows"), each timed
        # by CUDA events until the program carries these spans itself
        dtype = _dtype(tr["compute_dtype"])
        pol = make_gaussian_policy(p["env"], dtype=dtype)
        collect = rows_policy_rollout_fn(p["env"], lambda obs, g: pol(p["model"], obs, g), T, policy_aux=True)
        parts = {"collect_s": [], "batch_s": [], "fit_s": []}
        for _ in range(n):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            with torch.no_grad():
                p["state"], p["steps"], traj = collect(p["state"], p["steps"], p["gen"])
            ev[1].record()
            batch = PP.rows_batch(p["model"], traj, dtype=dtype)
            ev[2].record()
            PP.fit(p["model"], p["opt"], batch, tr["epochs"], dtype=dtype)
            ev[3].record()
            ev[3].synchronize()
            for k, (a, b) in zip(parts, ((0, 1), (1, 2), (2, 3))):
                parts[k].append(ev[a].elapsed_time(ev[b]) / 1e3)
            del traj, batch
        means = {k: statistics.fmean(v) for k, v in parts.items()}
        means["update_s"] = statistics.fmean(update_s)
        launches0 = F.rows_step_launches

        def traced():
            for _ in range(n):
                one_update()

        dev, host, wall = H.profile(traced, device)
        k2_n, k2_s = H.kernel_time(dev, "fused_step_kernel")
        summary = H.trace_summary(dev, host, wall)
        breakdown = summary.pop("breakdown")
        rows = F.pack_carry(p["env"].world, p["state"], p["env"]._fused_outputs)
        bound_s, by, ops, nbytes = C.k2_bound(cell.reference, rows, B)
        flops = C.ppo_update_flops(p["obs_dim"], p["act_dim"], tr["hidden"], B * len(cell.reference.ACT_SLOTS), T,
                                   tr["epochs"])
        readings.update(summary, updates=n, k2_launches=k2_n, k2_s=k2_s, k2_bound_s=bound_s,
                        update_bound_s=T * bound_s + flops / C.PEAK_BF16, **means)
        print(f"updates (CUDA events, mean of {n} each): " + ", ".join(f"{k} {v:.6f}" for k, v in means.items())
              + f"; the updates {update_s}", file=sys.stderr, flush=True)
        print(f"traced stretch: {n} updates, {summary['device_ops']} device operations, K2 {k2_n} launches "
              f"(fused.rows_step_launches counted {F.rows_step_launches - launches0}), "
              f"{k2_s / max(k2_n, 1) * 1e6:.3f} us a launch against a bound of {bound_s * 1e6:.3f} us ({by}: "
              f"{ops} operations, {nbytes} bytes); actor-critic {flops} FLOP an update; traced {wall:.6f} s",
              file=sys.stderr, flush=True)
        n = 3 * n

    peak = torch.cuda.max_memory_allocated() if str(device).startswith("cuda") else 0
    init, weights, s_run = p["init"], p["weights"], p["s_run"]
    p.clear()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = reference_updates(cell, init, weights, s_run, device)
    checks, ok = H.checks_of(compare(got, want), cell.limits)
    print(f"check of {len(got[0])} updates: {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    return {"correct": ok, "attempted": n, "failed": 0 if ok else 1, "e2e": e2e, "readings": readings,
            "breakdown": breakdown, "checks": checks, "memory_peak_bytes": peak}


def control(cell, seed, device):
    """The compared numbers of the lower-precision control: the reference
    with its physics in bfloat16 and its networks' products on float8
    (e4m3) inputs put in the program's place, against the reference."""
    import torch

    from portbench.reference.ppo import make_weights

    cfg, tr = cell.reference, cell.traffic
    s_init, s_run = H.seeds(seed)
    g_init = torch.Generator(device=device).manual_seed(s_init)
    init = cfg.initial_state(cell.num_envs, g_init, device)
    weights = make_weights(cfg.OBS_W, 2, tr["hidden"], g_init, device)
    want = reference_updates(cell, init, weights, s_run, device)
    low = reference_updates(cell, init, weights, s_run, device, phys_dtype=torch.bfloat16, mlp_dtype="fp8")
    return compare(low, want)
