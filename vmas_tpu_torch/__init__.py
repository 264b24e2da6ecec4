"""vmas_tpu_torch -- the PyTorch and CUDA port of vmas_tpu.

A second package beside the JAX one, which stays the reference: the same
module names, plain PyTorch around hand-written CUDA kernels for Hopper
(``csrc/``). Environments run on the GPU unless ``device="cpu"`` is passed.
Ported: every module of the JAX package -- all 43 scenario names
(``scenarios``, ``debug_scenarios``, ``mpe_scenarios``), every dynamics
model, the wrappers, the rollouts, PPO, rendering (``Environment.render``,
``render_interactively``; matplotlib is imported only where a frame is
drawn), checkpoints, ``checked_step``, profiling, env-axis sharding over
``torch.distributed`` (``parallel.distribute``) and the examples
(``vmas_tpu_torch.examples``).
"""

__version__ = "1.5.0"
__all__ = [
    "make_env",
    "render_interactively",
    "scenarios",
    "debug_scenarios",
    "mpe_scenarios",
]

from vmas_tpu_torch.make_env import make_env
from vmas_tpu_torch.environment import Wrapper
from vmas_tpu_torch.scenarios import _DEBUG, _MAIN, _MPE

# the JAX package's public name lists; as there, the ``scenarios``
# attribute shadows the scenarios subpackage
scenarios = sorted(_MAIN)
debug_scenarios = sorted(_DEBUG)
mpe_scenarios = sorted(_MPE)


def render_interactively(*args, **kwargs):
    """Play a scenario with the keyboard (``render/interactive.py``)."""
    from vmas_tpu_torch.render.interactive import render_interactively as _ri

    return _ri(*args, **kwargs)
