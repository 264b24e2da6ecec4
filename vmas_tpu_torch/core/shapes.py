"""Static shape descriptions.

Own copy of vmas_tpu/core/shapes.py (the port imports nothing of the JAX
package). Shapes are static metadata (Python floats): ``build_spec`` bakes
them into the world's spec, and stepping never re-reads them.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import Tuple

# Integer codes used by the WorldSpec arrays.
SPHERE = 0
BOX = 1
LINE = 2


class Shape(ABC):
    @abstractmethod
    def moment_of_inertia(self, mass: float) -> float: ...

    @abstractmethod
    def get_delta_from_anchor(self, anchor: Tuple[float, float]) -> Tuple[float, float]: ...

    @abstractmethod
    def circumscribed_radius(self) -> float: ...


class Box(Shape):
    """Axis-aligned-in-body-frame rectangle (reference core.py:102-137)."""

    code = BOX

    def __init__(self, length: float = 0.3, width: float = 0.1, hollow: bool = False):
        assert length > 0, f"Length must be > 0, got {length}"
        assert width > 0, f"Width must be > 0, got {width}"
        self.length = float(length)
        self.width = float(width)
        self.hollow = bool(hollow)

    def get_delta_from_anchor(self, anchor):
        return anchor[0] * self.length / 2, anchor[1] * self.width / 2

    def moment_of_inertia(self, mass: float) -> float:
        return (1 / 12) * mass * (self.length**2 + self.width**2)

    def circumscribed_radius(self) -> float:
        return math.sqrt((self.length / 2) ** 2 + (self.width / 2) ** 2)

    def __repr__(self):
        return f"Box(length={self.length}, width={self.width}, hollow={self.hollow})"


class Sphere(Shape):
    """Disc (reference core.py:140-168)."""

    code = SPHERE

    def __init__(self, radius: float = 0.05):
        assert radius > 0, f"Radius must be > 0, got {radius}"
        self.radius = float(radius)

    def get_delta_from_anchor(self, anchor):
        dx, dy = anchor[0] * self.radius, anchor[1] * self.radius
        norm = math.sqrt(dx * dx + dy * dy)
        if norm > self.radius:
            # Matches the reference's (buggy-looking but kept) renormalization
            # at core.py:150-157: delta /= norm * radius.
            dx /= norm * self.radius
            dy /= norm * self.radius
        return dx, dy

    def moment_of_inertia(self, mass: float) -> float:
        return (1 / 2) * mass * self.radius**2

    def circumscribed_radius(self) -> float:
        return self.radius

    def __repr__(self):
        return f"Sphere(radius={self.radius})"


class Line(Shape):
    """Segment (reference core.py:171-202)."""

    code = LINE

    def __init__(self, length: float = 0.5):
        assert length > 0, f"Length must be > 0, got {length}"
        self.length = float(length)
        self.width = 2  # render width only

    def moment_of_inertia(self, mass: float) -> float:
        return (1 / 12) * mass * (self.length**2)

    def circumscribed_radius(self) -> float:
        return self.length / 2

    def get_delta_from_anchor(self, anchor):
        return anchor[0] * self.length / 2, 0.0

    def __repr__(self):
        return f"Line(length={self.length})"
