"""vmas_tpu_torch -- the PyTorch and CUDA port of vmas_tpu.

A second package beside the JAX one, which stays the reference: the same
module names, plain PyTorch around hand-written CUDA kernels for Hopper
(``csrc/``). Environments run on the GPU unless ``device="cpu"`` is passed.
Ported: all 43 of the JAX package's scenario names (``scenarios``),
every dynamics model, the rollouts and PPO.
"""

__version__ = "1.5.0"
__all__ = ["make_env", "scenarios"]

from vmas_tpu_torch.make_env import make_env
from vmas_tpu_torch.scenarios import _PORTED

scenarios = sorted(_PORTED)
