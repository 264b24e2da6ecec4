"""vmas_tpu_torch -- the PyTorch and CUDA port of vmas_tpu.

A second package beside the JAX one, which stays the reference: the same
module names, plain PyTorch around hand-written CUDA kernels for Hopper
(``csrc/``). Environments run on the GPU unless ``device="cpu"`` is passed.
Ported: all 43 of the JAX package's scenario names (``scenarios``),
every dynamics model, the wrappers, the rollouts, PPO and rendering
(``Environment.render``, ``render_interactively``; matplotlib is imported
only where a frame is drawn).
"""

__version__ = "1.5.0"
__all__ = ["make_env", "render_interactively", "scenarios"]

from vmas_tpu_torch.make_env import make_env
from vmas_tpu_torch.scenarios import _PORTED

scenarios = sorted(_PORTED)


def render_interactively(*args, **kwargs):
    """Play a scenario with the keyboard (``render/interactive.py``)."""
    from vmas_tpu_torch.render.interactive import render_interactively as _ri

    return _ri(*args, **kwargs)
