from vmas_tpu_torch.dynamics.common import Dynamics
from vmas_tpu_torch.dynamics.holonomic import Holonomic

__all__ = ["Dynamics", "Holonomic"]
