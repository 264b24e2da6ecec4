"""The fused kernel's lane schedule (vmas_tpu_torch/csrc/fused_step.cu), held
on the CPU to the plain version it must match bitwise.

The kernel runs one env on a group of lanes: per substep each item type
(the joints, then ss, ls, ll, bs, bl, bb) is computed one item per lane into
a buffer, then the lane that owns an entity adds that type's contributions
to it by walking the entity's list (``KernelSpec.lists``, encoded in the
table buffer after the pair records). For every ported world:

* the lists hold every (item, side) that the plain version's accumulation
  (``fused._accumulate``) adds to an accumulator that is read, exactly once
  and in its order, as a recording run of ``_accumulate`` shows;
* an emulation of the schedule, decoding the lists from the int32 table as
  the kernel does, gives bitwise the rows of ``fused_step_plain`` and
  ``rows_step_plain`` from a contact-rich state at a small width.
"""

import numpy as np
import pytest
import torch

import vmas_tpu_torch.core as TC
from vmas_tpu_torch import make_env, testing
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.interop import state_from_numpy

B = 8

# world -> (make_env kwargs, state builder); the all-pairs world has no env
WORLDS = {
    "transport": ({"n_agents": 4}, testing.transport_contact_state),
    "balance": ({}, testing.balance_contact_state),
    "all_pairs": (None, None),
    "joint_passage": ({}, testing.joint_passage_contact_state),
    "waterfall": ({}, testing.waterfall_contact_state),
    "give_way": ({}, testing.give_way_contact_state),
    "multi_give_way": ({}, testing.multi_give_way_contact_state),
    "wind_flocking": ({}, testing.wind_flocking_state),
    "simple": ({"continuous_actions": False}, testing.mpe_state),
    "simple_spread": ({"continuous_actions": False}, testing.mpe_state),
}


@pytest.fixture(scope="module", params=list(WORLDS))
def case(request):
    """(name, env or None, world, state) from a seeded contact-rich state."""
    name = request.param
    kw, build = WORLDS[name]
    rng = np.random.default_rng(21)
    if kw is None:
        world = testing.all_pairs_world(TC, B, "cpu")
        return name, None, world, state_from_numpy(world, testing.all_pairs_state(rng, B))
    env = make_env(name, B, device="cpu", seed=0, fused_physics=True, **kw)
    return name, env, env.world, state_from_numpy(env.world, build(env, rng))


class _Tag:
    """A stand-in for one item's force or torque row: which item, and which
    side's term it is once added (a negated force is the -f side's)."""

    def __init__(self, item, side):
        self.item, self.side = item, side

    def __neg__(self):
        return _Tag(self.item, 1 - self.side)


class _Acc:
    """A stand-in accumulator that records, in order, the (item, side) of
    every term added to it."""

    def __init__(self, log):
        self.log = log

    def __add__(self, tag):
        if not self.log or self.log[-1] != (tag.item, tag.side):
            self.log.append((tag.item, tag.side))
        return self


def _items(ks, x):
    """The plain version's items of one substep on the rows ``x``, in
    accumulation order: (i, j, fx, fy, torque_i, torque_j)."""
    E = ks.E
    px, py, rot = list(x[:E]), list(x[E:2 * E]), list(x[4 * E:5 * E])
    jfr = list(x[9 * E:9 * E + ks.J])
    cs = F._trig_cache(rot)
    return list(F._joint_forces(ks, px, py, rot, jfr, cs)) + list(F._pair_forces(ks, px, py, rot, cs))


def _global_item(ks, t, k):
    return sum(len(getattr(ks, n)) for n in F.ITEM_TYPES[:t]) + k


def test_lists_cover_the_plain_accumulation(case):
    name, _, world, state = case
    ks = F._kernel_spec(world)
    x = F.state_rows(state)
    tagged = [
        (i, j, _Tag(n, 0), _Tag(n, 0), None if ti is None else _Tag(n, 0), None if tj is None else _Tag(n, 1))
        for n, (i, j, _, _, ti, tj) in enumerate(_items(ks, torch.cat([x, state.joint_fixed_rot.T])))
    ]
    logs = [[] for _ in range(ks.E)]
    Fx = [_Acc(logs[e]) if ks.movable[e] else None for e in range(ks.E)]
    Tq = [_Acc(logs[e]) if ks.rotatable[e] else None for e in range(ks.E)]
    F._accumulate(ks, tagged, Fx, list(Fx), Tq)
    for e in range(ks.E):
        want = sorted(set(logs[e]))
        assert logs[e] == want, f"{name}: entity {e} accumulates out of item order"
        got = [(_global_item(ks, t, k), side) for t, k, side in ks.lists[e]]
        assert got == want, f"{name}: entity {e}'s lane list differs from the plain accumulation"
    assert sum(map(len, ks.lists)) > 0 or not tagged


def _table_accumulate(ks, forces, Fx, Fy, Tq):
    """The kernel's schedule on the host: per item type, the items into a
    buffer, then per entity its list's entries of that type, decoded from
    the int32 table (segment offsets at o_lst + 8e, entries item << 1 |
    side), each added as the kernel adds it."""
    tab = ks.table
    o_lst = ks.table_offsets[-1]
    start = 0
    for t, name in enumerate(F.ITEM_TYPES):
        n = len(getattr(ks, name))
        buf = [(fx, fy, ti, tj) for _, _, fx, fy, ti, tj in forces[start:start + n]]
        start += n
        _, _, torque0, torque1 = F.ITEM_SIDES[name]
        for e in range(ks.E):
            lo, hi = int(tab[o_lst + 8 * e + t]), int(tab[o_lst + 8 * e + t + 1])
            for en in tab[lo:hi]:
                fx, fy, t0, t1 = buf[int(en) >> 1]
                neg = int(en) & 1
                if Fx[e] is not None:
                    Fx[e] = Fx[e] + (-fx if neg else fx)
                    Fy[e] = Fy[e] + (-fy if neg else fy)
                if Tq[e] is not None and (torque1 if neg else torque0):
                    Tq[e] = Tq[e] + (t1 if neg else t0)
    assert start == len(forces)


def test_schedule_emulation_is_bitwise_plain(case, monkeypatch):
    name, env, world, state = case
    ks = F._kernel_spec(world)
    fo = None if env is None else env._fused_outputs
    parts = [F.state_rows(state), state.joint_fixed_rot.T]
    if ks.dyn_gravity:
        parts += [state.dyn_gravity[..., 0].T, state.dyn_gravity[..., 1].T]
    if fo is not None:
        parts.append(torch.as_tensor(fo.scratch_rows(state), dtype=torch.float32))
    x = torch.cat(parts).contiguous()
    runs = {}
    rows = fo is not None and F.rows_step_supported(world, fo, env.agents)
    if rows:
        slots = [a.index for a in env.agents]
        carry = F.pack_carry(world, state, fo)
        rng = np.random.default_rng(22)
        steps = []
        for _ in range(2):  # two env steps per launch
            if fo.n_ctrl:
                acts = testing.pid_actions(env, rng)
                steps += [np.stack([a[:, 0] for a in acts]), np.stack([a[:, 1] for a in acts])]
            else:
                steps.append(rng.uniform(-1, 1, (2 * len(slots), B)))
        act = torch.as_tensor(np.concatenate(steps), dtype=torch.float32)
    for mode in ("plain", "lanes"):
        if mode == "lanes":
            monkeypatch.setattr(F, "_accumulate", _table_accumulate)
        runs[mode] = [F.fused_step_plain(world, x, fo)]
        if rows:
            runs[mode] += list(F.rows_step_plain(world, fo, slots, carry, act, k_steps=2))
    for got, want in zip(runs["lanes"], runs["plain"]):
        assert torch.equal(got, want), f"{name}: the lane schedule differs from the plain version"
    # the state moved under forces: some contact or joint acted
    contacts = F.contact_counts(world, x)
    assert sum(contacts.values()) + F.joint_counts(world, x)["force"] > 0 or name == "simple"


def test_lanes_rule():
    """The rule picks, per world, one thread per env where no item type has
    more than 3 items, else 8 lanes."""
    got = {}
    for name, (kw, _) in WORLDS.items():
        if kw is None:
            world = testing.all_pairs_world(TC, 2, "cpu")
        else:
            world = make_env(name, 2, device="cpu", seed=0, fused_physics=True, **kw).world
        got[name] = F._kernel_spec(world).lanes
    assert got == {"transport": 8, "balance": 8, "all_pairs": 8, "joint_passage": 8, "waterfall": 8,
                   "give_way": 8, "multi_give_way": 8, "wind_flocking": 1, "simple": 1, "simple_spread": 1}
