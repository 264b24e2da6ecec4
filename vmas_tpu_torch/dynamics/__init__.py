from vmas_tpu_torch.dynamics.common import Dynamics
from vmas_tpu_torch.dynamics.holonomic import Holonomic
from vmas_tpu_torch.dynamics.kinematic_bicycle import KinematicBicycle

__all__ = ["Dynamics", "Holonomic", "KinematicBicycle"]
