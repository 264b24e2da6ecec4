"""Constants and tensor utilities for the PyTorch port.

Counterpart of vmas_tpu/core/utils.py. Every helper is plain torch on
tensors that live on any device; divisions are guarded so gradients stay
finite on masked-out lanes, as in the JAX package.
"""

from __future__ import annotations

from enum import Enum

import torch

X = 0
Y = 1
# Same force-model constants as the JAX package (and the original VMAS).
LINE_MIN_DIST = 4 / 6e2
COLLISION_FORCE = 100.0
JOINT_FORCE = 130.0
TORQUE_CONSTRAINT_FORCE = 1.0

DRAG = 0.25
LINEAR_FRICTION = 0.0
ANGULAR_FRICTION = 0.0


class Color(Enum):
    RED = (0.75, 0.25, 0.25)
    GREEN = (0.25, 0.75, 0.25)
    BLUE = (0.25, 0.25, 0.75)
    LIGHT_GREEN = (0.45, 0.95, 0.45)
    WHITE = (0.75, 0.75, 0.75)
    GRAY = (0.25, 0.25, 0.25)
    BLACK = (0.15, 0.15, 0.15)
    ORANGE = (1.00, 0.50, 0.0)
    PINK = (0.97, 0.51, 0.75)
    PURPLE = (0.60, 0.31, 0.64)
    YELLOW = (0.87, 0.87, 0.0)


class TorchUtils:
    """Vector helpers; rotations are trailing-scalar tensors ``[...]``."""

    @staticmethod
    def rotate_vector(vector: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
        """Rotate 2D vectors ``[..., 2]`` by angles ``[...]``."""
        if angle.ndim == vector.ndim:
            angle = angle[..., 0]
        cos = torch.cos(angle)
        sin = torch.sin(angle)
        return torch.stack(
            [
                vector[..., X] * cos - vector[..., Y] * sin,
                vector[..., X] * sin + vector[..., Y] * cos,
            ],
            dim=-1,
        )

    @staticmethod
    def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """2D scalar cross product, shape ``[...]``."""
        return a[..., X] * b[..., Y] - a[..., Y] * b[..., X]

    @staticmethod
    def compute_torque(f: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        return TorchUtils.cross(r, f)

    @staticmethod
    def clamp_with_norm(tensor: torch.Tensor, max_norm) -> torch.Tensor:
        """Scale vectors whose norm exceeds ``max_norm`` back onto the ball."""
        norm = torch.linalg.vector_norm(tensor, dim=-1, keepdim=True)
        cond = norm > max_norm
        safe = torch.where(cond, norm, torch.ones_like(norm))
        return torch.where(cond, tensor / safe * max_norm, tensor)


def resolve_device(device) -> torch.device:
    """``None`` means the GPU; a CUDA device without a GPU raises rather
    than falling back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vmas_tpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def safe_div(num: torch.Tensor, den: torch.Tensor, eps: float = 0.0):
    """num / den with zero denominators replaced (caller must mask results)."""
    safe = torch.where(den == 0.0, torch.full_like(den, 1.0 if eps == 0.0 else eps), den)
    return num / safe


def safe_norm(vec: torch.Tensor, dim: int = -1):
    """L2 norm with a subgradient-safe zero (norm grad at 0 is 0, not NaN)."""
    sq = torch.sum(vec * vec, dim=dim)
    is_zero = sq == 0.0
    return torch.where(
        is_zero, torch.zeros_like(sq), torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq))
    )
