from vmas_tpu_torch.dynamics.common import Dynamics
from vmas_tpu_torch.dynamics.diff_drive import DiffDrive
from vmas_tpu_torch.dynamics.drone import Drone
from vmas_tpu_torch.dynamics.forward import Forward
from vmas_tpu_torch.dynamics.holonomic import Holonomic
from vmas_tpu_torch.dynamics.holonomic_with_rot import HolonomicWithRotation
from vmas_tpu_torch.dynamics.kinematic_bicycle import KinematicBicycle
from vmas_tpu_torch.dynamics.rotation import Rotation
from vmas_tpu_torch.dynamics.static import Static

__all__ = [
    "Dynamics", "Holonomic", "HolonomicWithRotation", "Forward", "Rotation", "Static", "DiffDrive",
    "KinematicBicycle", "Drone",
]
