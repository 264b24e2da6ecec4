"""Joints.

Counterpart of vmas_tpu/core/joints.py. A :class:`Joint` holds one rigid
:class:`JointConstraint` (``dist == 0``) or, for ``dist > 0``, an
intermediate landmark (a Line, or a Box when ``width > 0``) with two
zero-distance constraints to its ends. ``World.finalize`` bakes the
constraints into the joint table (``core.physics.build_spec``);
``Joint.sync``, which the environment runs after every scenario reset
(``World.sync_joints``), re-poses the landmark between its anchors and
infers the fixed rotation of each ``rotate=False`` constraint that was
given none.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vmas_tpu_torch.core.shapes import Box, Line
from vmas_tpu_torch.core.state import WorldState
from vmas_tpu_torch.core.utils import Color, TorchUtils


class JointConstraint:
    """Distance and rotation constraint between two anchor points;
    ``table_index`` addresses its column of ``state.joint_fixed_rot``."""

    def __init__(
        self,
        entity_a,
        entity_b,
        anchor_a: Tuple[float, float] = (0.0, 0.0),
        anchor_b: Tuple[float, float] = (0.0, 0.0),
        dist: float = 0.0,
        rotate: bool = True,
        fixed_rotation: Optional[float] = None,
    ):
        assert entity_a != entity_b, "Cannot join same entity"
        for anchor in (anchor_a, anchor_b):
            assert max(anchor) <= 1 and min(anchor) >= -1, (
                f"Joint anchor points should be between -1 and 1, got {anchor}"
            )
        assert dist >= 0, f"Joint dist must be >= 0, got {dist}"
        if fixed_rotation is not None:
            assert not rotate, "If fixed rotation is provided, rotate should be False"
        if rotate:
            assert fixed_rotation is None, "If you provide a fixed rotation, rotate should be False"
            fixed_rotation = 0.0

        self.entity_a = entity_a
        self.entity_b = entity_b
        self.anchor_a = anchor_a
        self.anchor_b = anchor_b
        self.dist = dist
        self.rotate = rotate
        self.fixed_rotation = fixed_rotation  # None: inferred at sync
        self.table_index: Optional[int] = None

    def pos_point(self, state: WorldState, entity):
        """World position of this constraint's anchor on ``entity``: [B, 2]."""
        anchor = self.anchor_a if entity is self.entity_a else self.anchor_b
        pos = entity.pos(state)
        delta = torch.as_tensor(entity.shape.get_delta_from_anchor(anchor), dtype=torch.float32, device=pos.device)
        return pos + TorchUtils.rotate_vector(delta.expand(pos.shape), entity.rot(state))


class Joint:
    def __init__(
        self,
        entity_a,
        entity_b,
        anchor_a: Tuple[float, float] = (0.0, 0.0),
        anchor_b: Tuple[float, float] = (0.0, 0.0),
        rotate_a: bool = True,
        rotate_b: bool = True,
        dist: float = 0.0,
        collidable: bool = False,
        width: float = 0.0,
        mass: float = 1.0,
        fixed_rotation_a: Optional[float] = None,
        fixed_rotation_b: Optional[float] = None,
    ):
        assert entity_a != entity_b, "Cannot join same entity"
        for anchor in (anchor_a, anchor_b):
            assert max(anchor) <= 1 and min(anchor) >= -1, (
                f"Joint anchor points should be between -1 and 1, got {anchor}"
            )
        assert dist >= 0, f"Joint dist must be >= 0, got {dist}"
        if dist == 0:
            assert not collidable, "Cannot have collidable joint with dist 0"
            assert width == 0, "Cannot have width for joint with dist 0"
            assert fixed_rotation_a == fixed_rotation_b, (
                "If dist is 0, fixed_rotation_a and fixed_rotation_b should be the same"
            )
        if fixed_rotation_a is not None:
            assert not rotate_a, "If you provide a fixed rotation for a, rotate_a should be False"
        if fixed_rotation_b is not None:
            assert not rotate_b, "If you provide a fixed rotation for b, rotate_b should be False"
        if width > 0:
            assert collidable

        self.entity_a = entity_a
        self.entity_b = entity_b
        self.rotate_a = rotate_a
        self.rotate_b = rotate_b
        self.fixed_rotation_a = fixed_rotation_a
        self.fixed_rotation_b = fixed_rotation_b
        self.landmark = None
        self.joint_constraints = []

        if dist == 0:
            self.joint_constraints.append(
                JointConstraint(
                    entity_a, entity_b,
                    anchor_a=anchor_a, anchor_b=anchor_b,
                    dist=dist, rotate=rotate_a and rotate_b,
                    fixed_rotation=fixed_rotation_a,
                )
            )
        else:
            from vmas_tpu_torch.core.world import Landmark

            self.landmark = Landmark(
                name=f"joint {entity_a.name} {entity_b.name}",
                collide=collidable,
                movable=True,
                rotatable=True,
                mass=mass,
                shape=(Box(length=dist, width=width) if width != 0 else Line(length=dist)),
                color=Color.BLACK,
                is_joint=True,
            )
            self.joint_constraints += [
                JointConstraint(
                    self.landmark, entity_a,
                    anchor_a=(-1, 0), anchor_b=anchor_a,
                    dist=0.0, rotate=rotate_a, fixed_rotation=fixed_rotation_a,
                ),
                JointConstraint(
                    self.landmark, entity_b,
                    anchor_a=(1, 0), anchor_b=anchor_b,
                    dist=0.0, rotate=rotate_b, fixed_rotation=fixed_rotation_b,
                ),
            ]

    def sync(self, world, state: WorldState) -> WorldState:
        """Re-pose the joint landmark between its anchors and infer the fixed
        rotations left to be inferred."""
        if self.landmark is None:
            return state
        c0, c1 = self.joint_constraints
        pos_a = c0.pos_point(state, self.entity_a)
        pos_b = c1.pos_point(state, self.entity_b)
        state = self.landmark.set_pos(state, (pos_a + pos_b) / 2)
        angle = torch.atan2(pos_b[:, 1] - pos_a[:, 1], pos_b[:, 0] - pos_a[:, 0])
        state = self.landmark.set_rot(state, angle)

        jfr = state.joint_fixed_rot
        if not self.rotate_a and self.fixed_rotation_a is None and c0.table_index is not None:
            jfr = jfr.clone()
            jfr[:, c0.table_index] = angle - self.entity_a.rot(state)
        if not self.rotate_b and self.fixed_rotation_b is None and c1.table_index is not None:
            jfr = jfr.clone()
            jfr[:, c1.table_index] = angle - self.entity_b.rot(state)
        return state.replace(joint_fixed_rot=jfr)
