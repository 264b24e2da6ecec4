"""The port's op-cost probe (vmas_tpu_torch/opcost.py, the plain version of
csrc/opcost.cu) against the JAX package's Pallas probe.

The probe's body is tests/golden/time_mosaic_opcost.py's ``make_kernel``,
run here as ``pl.pallas_call(make_kernel(n_ops, (1, B), trans), ...,
interpret=True)`` on the CPU: 54 rows of inputs in [0.5, 2], made from a
seed with numpy, a chain of ``n_ops`` dependent operations into row 0,
rows 1..53 copied. The counts cover the CUDA kernel's remainder paths
(``n_ops`` not a multiple of the chain's period, 3 or 4) and a long chain.

Tolerances: the copied rows bitwise. The ALU chain (multiply, add,
compare, select, max) rtol 1e-4: XLA's CPU backend fuses the probe's ``acc
* r + 0.5`` into one fused multiply-add, which the port's version does not
(nor does the CUDA kernel, built with ``--fmad=false``), and the chain's
subtractions carry that last-bit difference on (2.3e-5 relative after 100
operations). So the ALU chain is also held bitwise to a numpy chain of the
same operations, with the multiply-add fused (the JAX probe) and unfused
(the port). The transcendental chain (sqrt, division, exp, log1p) rtol
1e-5 atol 1e-6: XLA's and PyTorch's exp and log1p on the CPU may round
differently in the last bit.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vmas_tpu_torch import opcost

R, B = 54, 128
PROBE = os.path.join(os.path.dirname(__file__), "golden", "time_mosaic_opcost.py")


@pytest.fixture(scope="module")
def probe():
    """The JAX probe module; it reads ``sys.argv[1]`` as its width when
    imported, so it is loaded with a bare argv."""
    argv = sys.argv
    sys.argv = ["probe"]
    try:
        spec = importlib.util.spec_from_file_location("time_mosaic_opcost", PROBE)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    assert mod.R == R
    return mod


def _inputs(seed):
    return np.random.default_rng(seed).uniform(0.5, 2.0, (R, B)).astype(np.float32)


def _numpy_alu(x, n_ops, fused_mul_add):
    """The ALU chain in numpy f32, with ``acc * r + 0.5`` rounded once (a
    fused multiply-add: the f64 product of two f32 values is exact) or
    twice."""
    acc = x[0]
    for i in range(n_ops):
        r = x[(i + 1) % R]
        if i % 3 == 0:
            acc = (acc.astype(np.float64) * r + 0.5).astype(np.float32) if fused_mul_add else acc * r + np.float32(0.5)
        elif i % 3 == 1:
            acc = np.where(acc > r, acc - r, acc)
        else:
            acc = np.maximum(acc, r * np.float32(0.25))
    return acc


def _jax_probe(probe, x, n_ops, trans):
    run = pl.pallas_call(
        probe.make_kernel(n_ops, (1, B), trans),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True,
    )
    return np.asarray(jax.jit(run)(jnp.asarray(x)))


@pytest.mark.parametrize("trans,n_ops", [(False, 0), (False, 5), (False, 100), (True, 7), (True, 100)])
def test_plain_matches_pallas_probe(probe, trans, n_ops):
    x = _inputs(n_ops + 1000 * trans)
    want = _jax_probe(probe, x, n_ops, trans)
    got = opcost.opcost_chain_plain(torch.as_tensor(x), n_ops, trans).numpy()
    np.testing.assert_array_equal(got[1:], x[1:])
    np.testing.assert_array_equal(want[1:], x[1:])
    if trans:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=0)
        np.testing.assert_array_equal(want[0], _numpy_alu(x, n_ops, fused_mul_add=True))
        np.testing.assert_array_equal(got[0], _numpy_alu(x, n_ops, fused_mul_add=False))
    if n_ops:
        assert not np.array_equal(got[0], x[0])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing; the chain wraps its operand row around after row R - 1."""
    x = torch.as_tensor(_inputs(3))
    n = opcost.opcost_launches
    torch.testing.assert_close(opcost.opcost_chain(x, 130, False), opcost.opcost_chain_plain(x, 130, False),
                               atol=0, rtol=0)
    assert opcost.opcost_launches == n
    # with two rows, operation 1 reads row 0: the input row, not the chain
    one = opcost.opcost_chain_plain(x[:2], 2, False)
    acc = torch.where(x[0] * x[1] + 0.5 > x[0], x[0] * x[1] + 0.5 - x[0], x[0] * x[1] + 0.5)
    assert torch.equal(one[0], acc)
