"""The yardstick of the shares: the card's published peaks and the work a
step needs, counted from the configuration's shapes.

The operation counts per pair, joint and entity are read off the fused
step's device code (``csrc/fused_step.cu``): +, -, *, /, sqrt and a compare
count 1; cos, sin, exp, log1p and fmod count ``TRIG_OPS``. They are a frozen
copy of the counts the port's chip script uses, so a share reads the same
work whatever implements it. Bytes count each input byte read once and each
output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_F32 = 67e12  # float32 FLOP/s outside the tensor cores
PEAK_BF16 = 989e12  # bf16 tensor-core FLOP/s

TRIG_OPS = 20
# per pair and substep, without its line-line tests: ss the penalty force
# 60 and its accumulation 5; ls a closest point on a segment 15, the
# penalty 60, the torque and accumulation 12; ll 60 + 20; bs 4 edges x 29
# (a closest point 15, its distance 7, a first-minimum update 7) + the
# inner point 20 + the penalty 60 + 13; bl 4 x 14 + 20 + 60 + 20; bb 8 x
# (14 + 4 x 14) + 2 x 20 + 60 + 20
PAIR_OPS = {"ss": 65, "ls": 87, "ll": 80, "bs": 209, "bl": 156, "bb": 680}
# a line-line test: 43 where the segments cross, 43 + 4 x (15 + 8) where not
LL_CROSS_OPS, LL_MISS_OPS = 43, 135
# per joint constraint and substep: 4 anchor coordinates 16, the attractive
# and the repulsive penalty 2 x 60, their sum 2, two torques 12, the
# accumulation 8; a rotate=False constraint adds its exponential torque
JOINT_OPS, JOINT_FIXED_OPS = 158, 31
# per entity and substep: clamps, integration and drag
ENTITY_OPS = 20


def step_ops_per_env(spec, emit_ops, n_out):
    """Operations of one env step of the fused rows step without its
    line-line tests: every substep's entity terms, the cos and sin of each
    entity whose rotation a pair or joint reads, the pairs and the joints;
    then the emit's ``emit_ops`` and one per emitted row."""
    per_substep = (ENTITY_OPS * spec.E + 2 * TRIG_OPS * len(spec.trig)
                   + sum(PAIR_OPS[t] * len(getattr(spec, t)) for t in PAIR_OPS)
                   + sum(JOINT_OPS + (0 if j[7] else JOINT_FIXED_OPS) for j in spec.joints))
    return spec.substeps * per_substep + emit_ops + n_out


def line_line_ops(spec, tests, crossing):
    """Operations of the line-line tests one step runs on its inputs:
    ``tests`` per substep over all envs, ``crossing`` of them between
    segments that cross (which stop early)."""
    return spec.substeps * (crossing * LL_CROSS_OPS + (tests - crossing) * LL_MISS_OPS)


def rows_step_bytes(spec, n_scratch, n_act, n_out, B):
    """Bytes one launch of the rows step moves: the carry read and written
    (9E + J + K rows), the action rows read, the emit rows written, f32."""
    r_in = 9 * spec.E + spec.J + n_scratch
    return (r_in + n_act + r_in + n_out) * B * 4


def bound_seconds(ops, nbytes):
    """The least time the card needs for ``ops`` f32 operations and
    ``nbytes`` bytes, and which of the two binds."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def mlp_macs(sizes):
    """Multiply-adds of one sample through a dense trunk of these widths."""
    return sum(m * n for m, n in zip(sizes[:-1], sizes[1:]))


def ppo_update_flops(obs_dim, act_dim, hidden, n_samples, horizon, epochs):
    """Matmul FLOPs of one PPO update on ``n_samples`` agent-samples a step:
    the policy's forward at each collection step, the value trunk's forward
    over T+1 steps, and each epoch's forward through both trunks and their
    backward (the weights' gradients everywhere, the inputs' gradients but
    at the first layer, whose input is the observation)."""
    pi = (obs_dim,) + tuple(hidden) + (act_dim,)
    v = (obs_dim,) + tuple(hidden) + (1,)
    fwd = lambda sizes: 2 * mlp_macs(sizes)
    bwd = lambda sizes: 2 * mlp_macs(sizes) + 2 * mlp_macs(sizes[1:])
    collect = horizon * n_samples * fwd(pi)
    values = (horizon + 1) * n_samples * fwd(v)
    fit = epochs * horizon * n_samples * (fwd(pi) + fwd(v) + bwd(pi) + bwd(v))
    return collect + values + fit


def line_line_tests(spec, rows):
    """(line-line tests, of them between crossing segments) that one substep
    of the step runs on the rows [9E + ..., B]: those of the ll, bl and bb
    pairs, counted by running the reference's contact forces with its
    segment intersection probed."""
    from portbench.reference import physics as P

    E = spec.E
    px, py, rot = list(rows[:E]), list(rows[E:2 * E]), list(rows[4 * E:5 * E])
    hits = []
    real = P._intersection

    def probe(*args):
        out = real(*args)
        hits.append((out[2].numel(), int(out[2].sum())))
        return out

    P._intersection = probe
    try:
        for _ in P._pair_forces(spec, px, py, rot):
            pass
    finally:
        P._intersection = real
    return sum(n for n, _ in hits), sum(h for _, h in hits)


def k2_bound(cfg, rows, B):
    """One rows-step launch's counted bound for configuration ``cfg`` on the
    carry rows ``rows`` [R_in, B] -> (seconds, what binds, operations,
    bytes); a launch is one env step."""
    from portbench.reference.physics import Spec

    spec = Spec(cfg.WORLD)
    tests, crossing = line_line_tests(spec, rows)
    ops = step_ops_per_env(spec, cfg.EMIT_OPS, cfg.N_OUT) * B + line_line_ops(spec, tests, crossing)
    nbytes = rows_step_bytes(spec, len(cfg.CARRY_EXTRA_IDX), 2 * len(cfg.ACT_SLOTS), cfg.N_OUT, B)
    t, by = bound_seconds(ops, nbytes)
    return t, by, ops, nbytes
