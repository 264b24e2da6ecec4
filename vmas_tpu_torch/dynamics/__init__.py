from vmas_tpu_torch.dynamics.common import Dynamics
from vmas_tpu_torch.dynamics.holonomic import Holonomic
from vmas_tpu_torch.dynamics.holonomic_with_rot import HolonomicWithRotation
from vmas_tpu_torch.dynamics.kinematic_bicycle import KinematicBicycle

__all__ = ["Dynamics", "Holonomic", "HolonomicWithRotation", "KinematicBicycle"]
