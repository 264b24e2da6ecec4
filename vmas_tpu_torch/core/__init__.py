from vmas_tpu_torch.core.joints import Joint, JointConstraint
from vmas_tpu_torch.core.shapes import Box, Line, Shape, Sphere
from vmas_tpu_torch.core.state import WorldState, blend
from vmas_tpu_torch.core.utils import Color, TorchUtils, X, Y
from vmas_tpu_torch.core.world import Agent, Entity, Landmark, World

__all__ = [
    "Agent", "Box", "Color", "Entity", "Joint", "JointConstraint", "Landmark", "Line", "Shape", "Sphere",
    "TorchUtils", "World", "WorldState", "blend", "X", "Y",
]
