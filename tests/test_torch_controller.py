"""The port's PID velocity controller (vmas_tpu_torch/controllers) against the
JAX package's: the rows form the fused kernel's in-kernel process_action
repeats (``rows_step``) and the state form ``env.step`` runs
(``process_force``), on the same seeded inputs, made with numpy.

Both run op by op on the CPU (the JAX side eagerly, so XLA fuses nothing),
so they agree bitwise; the tolerance stated is atol 1e-7. Also the two
clamps of a velocity command: the port's ``clamp_with_norm`` against the
JAX package's, bitwise (``torch.linalg.vector_norm`` rounds as
``jnp.linalg.norm`` does), and the velocity-controlled scenarios' row-norm
clamp against the kernel's form, ``sqrt(x*x + y*y)``, bitwise (it differs
from the other by an ulp in some vectors); and the division by ``dt`` that
the port takes as one IEEE division: on the CPU it gives the bits that
``/ dt`` gave before.
"""

import warnings
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmas_tpu.controllers import VelocityController as JaxVC
from vmas_tpu.core.utils import JaxUtils
from vmas_tpu_torch.controllers import VelocityController as TorchVC
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import TorchUtils

B = 16
ATOL = 1e-7

# (ctrl_params, pid_form, force limits): give_way's, joint_passage's, one
# without an integrator, the parallel form, and an integrator without a
# cutoff (no force limits)
CONFIGS = {
    "give_way": ([2, 6, 0.002], "standard", dict(f_range=1.1)),
    "joint_passage": ([2.0, 10, 0.00001], "standard", dict(f_range=0.8)),
    "no_integrator": ([1.5, 0, 0.01], "standard", dict(f_range=1.0)),
    "parallel": ([2.0, 0.5, 0.004], "parallel", dict(max_f=0.7, f_range=1.2)),
    "no_cutoff": ([2.0, 6, 0.002], "standard", {}),
}


def _agent(limits, mass=1.3):
    return SimpleNamespace(max_f=limits.get("max_f"), f_range=limits.get("f_range"), mass=mass, name="a")


def _pair(config):
    params, form, limits = CONFIGS[config]
    world = SimpleNamespace(dt=0.05)
    with warnings.catch_warnings():
        # "no_cutoff": both packages warn that the integrator can wind up
        warnings.simplefilter("ignore")
        return JaxVC(_agent(limits), world, params, form), TorchVC(_agent(limits), world, params, form)


def _rows(vc, rng):
    """Seeded rows (ux, uy, vx, vy, acx, acy, prx, pry): a quarter of the
    integrator rows at the windup cutoff, so the clip acts."""
    r = rng.normal(0, 0.5, (8, B)).astype(np.float32)
    cut = vc.integrator_windup_cutoff
    if cut is not None:
        r[4:6, ::4] = np.float32(cut) * np.sign(r[4:6, ::4])
    return r


@pytest.mark.parametrize("reset", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_rows_step_matches_jax(config, reset):
    jvc, tvc = _pair(config)
    assert tvc.rows_params() == (0.05, float(jvc.ctrl_gain), 1.3, jvc.use_integrator,
                                 float(1.0 / jvc.integralTs) if jvc.use_integrator else 0.0,
                                 None if jvc.integrator_windup_cutoff is None else float(jvc.integrator_windup_cutoff),
                                 float(jvc.derivativeTs))
    rng = np.random.default_rng(len(config) + 7 * reset)
    rows = _rows(tvc, rng)
    mask = rng.random(B) < 0.3 if reset else None
    j_out = jvc.rows_step()(*[jnp.asarray(r) for r in rows], None if mask is None else jnp.asarray(mask))
    t_out = tvc.rows_step()(*[torch.as_tensor(r) for r in rows], None if mask is None else torch.as_tensor(mask))
    for name, j, t in zip(("fx", "fy", "acx", "acy", "prx", "pry"), j_out, t_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0, err_msg=name)
    if config == "give_way":
        # the clip acted in the cutoff lanes
        assert (np.abs(t_out[2].numpy()) == np.float32(tvc.integrator_windup_cutoff)).any()


class _State:
    """The few fields process_force reads and writes, for either package."""

    def __init__(self, u, vel, scenario):
        self.u, self._vel, self.scenario = u, vel, scenario

    def replace(self, scenario):
        return _State(self.u, self._vel, scenario)


def _bind(vc):
    vc.agent.u = lambda st: st.u
    vc.agent.vel = lambda st: st._vel
    vc.agent.set_u = lambda st, u: _State(u, st._vel, st.scenario)
    return vc


@pytest.mark.parametrize("config", ["give_way", "parallel"])
def test_process_force_matches_jax(config):
    """The state form, memory included, twice in a row."""
    jvc, tvc = _pair(config)
    _bind(jvc), _bind(tvc)
    rng = np.random.default_rng(5)
    r = _rows(tvc, rng)
    u, vel = r[0:2].T.copy(), r[2:4].T.copy()
    mem = {"accum_errs": r[4:6].T.copy(), "prev_err": r[6:8].T.copy()}
    js = _State(jnp.asarray(u), jnp.asarray(vel), {jvc.key: {k: jnp.asarray(v) for k, v in mem.items()}})
    ts = _State(torch.as_tensor(u), torch.as_tensor(vel), {tvc.key: {k: torch.as_tensor(v) for k, v in mem.items()}})
    for _ in range(2):
        js, ts = jvc.process_force(js), tvc.process_force(ts)
        np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=ATOL, rtol=0, err_msg="force")
        for k in mem:
            np.testing.assert_allclose(ts.scenario[tvc.key][k].numpy(), np.asarray(js.scenario[jvc.key][k]),
                                       atol=ATOL, rtol=0, err_msg=k)


def test_dt_division_is_bitwise_on_cpu():
    """``_div(x, dt)`` (a tensor divided by a 0-dim tensor) gives on the CPU
    the bits of ``x / dt``, the form process_force used before; on a CUDA
    tensor only the former is an IEEE division."""
    x = torch.as_tensor(np.random.default_rng(0).normal(0, 3, 4096).astype(np.float32))
    for dt in (0.05, 0.1, 0.03, 1 / 3):
        assert torch.equal(F._div(x, dt), x / dt)


def test_clamps_match_their_references():
    """On vectors that straddle the bound (and zero vectors):
    clamp_with_norm against the JAX package's, and clamp_with_row_norm on
    [B, 2] against the rows form's ops on [B] rows (PidActRows's clamp),
    both bitwise; the two clamps differ from each other in the last bit of
    some vectors."""
    rng = np.random.default_rng(3)
    v = rng.normal(0, 0.5, (4096, 2)).astype(np.float32)
    v[:8] = 0.0
    ux, uy = torch.as_tensor(v[:, 0]), torch.as_tensor(v[:, 1])
    for bound in (0.5, 0.35):
        t = TorchUtils.clamp_with_norm(torch.as_tensor(v), bound).numpy()
        np.testing.assert_array_equal(t, np.asarray(JaxUtils.clamp_with_norm(jnp.asarray(v), bound)))
        r = F.clamp_with_row_norm(torch.as_tensor(v), bound).numpy()
        n = torch.sqrt(ux * ux + uy * uy)
        over = n > bound
        den = torch.where(over, n, 1.0)
        np.testing.assert_array_equal(r[:, 0], torch.where(over, ux / den * bound, ux).numpy())
        np.testing.assert_array_equal(r[:, 1], torch.where(over, uy / den * bound, uy).numpy())
        assert over.any() and (r != t).any()
