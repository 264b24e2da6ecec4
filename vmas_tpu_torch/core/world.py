"""Entity handles and the World builder.

Counterpart of vmas_tpu/core/world.py. Scenarios declare entities as in
VMAS (``World(batch_dim, device, ...)``, ``world.add_agent(Agent(...))``);
``finalize()`` bakes the static structure into a spec, and the step
functions are plain torch over a :class:`WorldState` of ``[B, E, ...]``
tensors on ``world.device``.

Not ported yet: joints (``add_joint``) and ray casting (``cast_rays``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vmas_tpu_torch.core import physics as _physics
from vmas_tpu_torch.core import queries as _queries
from vmas_tpu_torch.core.shapes import Box, Line, Shape, Sphere
from vmas_tpu_torch.core.state import WorldState
from vmas_tpu_torch.core.utils import (
    ANGULAR_FRICTION,
    COLLISION_FORCE,
    Color,
    DRAG,
    JOINT_FORCE,
    LINEAR_FRICTION,
    TORQUE_CONSTRAINT_FORCE,
    resolve_device,
)


def _broadcast_value(value, batch_dim: int, trailing: Tuple[int, ...], device):
    value = torch.as_tensor(value, dtype=torch.float32, device=device)
    target = (batch_dim,) + trailing
    if value.ndim < len(target):
        value = value.expand(target)
    return value


def _set_column(arr: torch.Tensor, index: int, value: torch.Tensor) -> torch.Tensor:
    """``arr`` with column ``index`` of axis 1 replaced (out of place)."""
    out = arr.clone()
    out[:, index] = value
    return out


class Entity:
    """Build-time handle for a physical entity. After ``World.finalize`` its
    ``index`` addresses the entity's row in every ``[B, E, ...]`` tensor."""

    def __init__(
        self,
        name: str,
        movable: bool = False,
        rotatable: bool = False,
        collide: bool = True,
        density: float = 25.0,  # unused, kept for API parity
        mass: float = 1.0,
        shape: Shape = None,
        v_range: float = None,
        max_speed: float = None,
        color=Color.GRAY,
        is_joint: bool = False,
        drag: float = None,
        linear_friction: float = None,
        angular_friction: float = None,
        gravity: Union[None, Tuple[float, float], Sequence[float]] = None,
        collision_filter: Callable[["Entity"], bool] = lambda _: True,
    ):
        if shape is None:
            shape = Sphere()
        self.name = name
        self.movable = movable
        self.rotatable = rotatable
        self.collide = collide
        self.density = density
        self.mass = mass
        self.shape = shape
        self.v_range = v_range
        self.max_speed = max_speed
        self._color = color
        self.is_joint = is_joint
        self.drag = drag
        self.linear_friction = linear_friction
        self.angular_friction = angular_friction
        self.gravity = None if gravity is None else tuple(np.asarray(gravity, dtype=np.float32).reshape(2))
        self.collision_filter = collision_filter
        self.goal: Optional[Entity] = None
        self.index: Optional[int] = None  # entity row, set by World.finalize
        self._world: Optional[World] = None

    @property
    def moment_of_inertia(self) -> float:
        return self.shape.moment_of_inertia(self.mass)

    @property
    def color(self):
        return self._color.value if isinstance(self._color, Color) else self._color

    @color.setter
    def color(self, value):
        self._color = value

    def collides(self, entity: "Entity") -> bool:
        if not self.collide:
            return False
        return self.collision_filter(entity)

    # -- functional state access ---------------------------------------
    def pos(self, state: WorldState):
        return state.pos[:, self.index]

    def vel(self, state: WorldState):
        return state.vel[:, self.index]

    def rot(self, state: WorldState):
        """[B] trailing-scalar rotation."""
        return state.rot[:, self.index]

    def ang_vel(self, state: WorldState):
        return state.ang_vel[:, self.index]

    def is_rendering(self, state: WorldState):
        return state.rendering[:, self.index]

    def _set(self, state: WorldState, field: str, value, trailing, env_mask=None):
        arr = getattr(state, field)
        value = _broadcast_value(value, arr.shape[0], trailing, arr.device)
        if env_mask is not None:
            m = env_mask.reshape(env_mask.shape + (1,) * (value.ndim - 1))
            value = torch.where(m, value, arr[:, self.index])
        return state.replace(**{field: _set_column(arr, self.index, value)})

    def set_pos(self, state: WorldState, pos, env_mask=None) -> WorldState:
        return self._set(state, "pos", pos, (2,), env_mask)

    def set_vel(self, state: WorldState, vel, env_mask=None) -> WorldState:
        return self._set(state, "vel", vel, (2,), env_mask)

    def set_rot(self, state: WorldState, rot, env_mask=None) -> WorldState:
        rot = torch.as_tensor(rot, dtype=torch.float32, device=state.device)
        if rot.ndim and rot.shape[-1] == 1:
            rot = rot[..., 0]
        return self._set(state, "rot", rot, (), env_mask)

    def set_ang_vel(self, state: WorldState, ang_vel, env_mask=None) -> WorldState:
        ang_vel = torch.as_tensor(ang_vel, dtype=torch.float32, device=state.device)
        if ang_vel.ndim and ang_vel.shape[-1] == 1:
            ang_vel = ang_vel[..., 0]
        return self._set(state, "ang_vel", ang_vel, (), env_mask)

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class Landmark(Entity):
    def __init__(
        self,
        name: str,
        shape: Shape = None,
        movable: bool = False,
        rotatable: bool = False,
        collide: bool = True,
        density: float = 25.0,
        mass: float = 1.0,
        v_range: float = None,
        max_speed: float = None,
        color=Color.GRAY,
        is_joint: bool = False,
        drag: float = None,
        linear_friction: float = None,
        angular_friction: float = None,
        gravity: float = None,
        collision_filter: Callable[[Entity], bool] = lambda _: True,
    ):
        super().__init__(
            name, movable, rotatable, collide, density, mass, shape, v_range,
            max_speed, color, is_joint, drag, linear_friction, angular_friction,
            gravity, collision_filter,
        )


class Agent(Entity):
    """An actuated entity. ``u_range``/``u_multiplier``/``u_noise`` are kept
    as per-action-dim numpy arrays; ``dynamics`` maps the decoded action to
    the entity's force and torque."""

    def __init__(
        self,
        name: str,
        shape: Shape = None,
        movable: bool = True,
        rotatable: bool = True,
        collide: bool = True,
        density: float = 25.0,
        mass: float = 1.0,
        f_range: float = None,
        max_f: float = None,
        t_range: float = None,
        max_t: float = None,
        v_range: float = None,
        max_speed: float = None,
        color=Color.BLUE,
        alpha: float = 0.5,
        obs_range: float = None,
        obs_noise: float = None,
        u_noise: Union[float, Sequence[float]] = 0.0,
        u_range: Union[float, Sequence[float]] = 1.0,
        u_multiplier: Union[float, Sequence[float]] = 1.0,
        action_script: Callable = None,
        c_noise: float = 0.0,
        silent: bool = True,
        adversary: bool = False,
        drag: float = None,
        linear_friction: float = None,
        angular_friction: float = None,
        gravity: float = None,
        collision_filter: Callable[[Entity], bool] = lambda _: True,
        dynamics=None,
        action_size: int = None,
        discrete_action_nvec: List[int] = None,
    ):
        super().__init__(
            name, movable, rotatable, collide, density, mass, shape, v_range,
            max_speed, color, False, drag, linear_friction, angular_friction,
            gravity, collision_filter,
        )
        if action_size is not None and discrete_action_nvec is not None:
            if action_size != len(discrete_action_nvec):
                raise ValueError(
                    f"action_size {action_size} is inconsistent with discrete_action_nvec {discrete_action_nvec}"
                )
        if discrete_action_nvec is not None and not all(n > 1 for n in discrete_action_nvec):
            raise ValueError(
                f"All values in discrete_action_nvec must be greater than 1, got {discrete_action_nvec}"
            )

        self.obs_range = obs_range
        self.obs_noise = obs_noise if obs_noise is not None else 0
        self.f_range = f_range
        self.max_f = max_f
        self.t_range = t_range
        self.max_t = max_t
        self.action_script = action_script
        self.c_noise = c_noise
        self.silent = silent
        self.adversary = adversary
        self.alpha = alpha

        from vmas_tpu_torch.dynamics.holonomic import Holonomic

        self.dynamics = dynamics if dynamics is not None else Holonomic()
        if action_size is not None:
            self.action_size = action_size
        elif discrete_action_nvec is not None:
            self.action_size = len(discrete_action_nvec)
        else:
            self.action_size = self.dynamics.needed_action_size
        if discrete_action_nvec is None:
            self.discrete_action_nvec = [3] * self.action_size
        else:
            self.discrete_action_nvec = list(discrete_action_nvec)
        self.dynamics.agent = self

        def _per_dim(v):
            return np.asarray(
                v if isinstance(v, (list, tuple)) else [v] * self.action_size,
                dtype=np.float32,
            )

        self.u_range_array = _per_dim(u_range)
        self.u_multiplier_array = _per_dim(u_multiplier)
        self.u_noise_array = _per_dim(u_noise)
        self.slot: Optional[int] = None  # index into world.agents

    @property
    def u_range(self):
        a = self.u_range_array
        return a if np.ptp(a) else float(a[0])

    @property
    def u_multiplier(self):
        a = self.u_multiplier_array
        return a if np.ptp(a) else float(a[0])

    @property
    def u_noise(self):
        a = self.u_noise_array
        return a if np.ptp(a) else float(a[0])

    # -- functional accessors ------------------------------------------
    def u(self, state: WorldState):
        return state.u[self.slot]

    def set_u(self, state: WorldState, u) -> WorldState:
        u_list = list(state.u)
        u_list[self.slot] = torch.as_tensor(u, dtype=torch.float32, device=state.device)
        return state.replace(u=tuple(u_list))

    def comm(self, state: WorldState):
        return state.c[:, self.slot]

    def force(self, state: WorldState):
        return state.force[:, self.index]

    def set_force(self, state: WorldState, force) -> WorldState:
        force = torch.as_tensor(force, dtype=torch.float32, device=state.device)
        return state.replace(force=_set_column(state.force, self.index, force))

    def torque(self, state: WorldState):
        return state.torque[:, self.index]

    def set_torque(self, state: WorldState, torque) -> WorldState:
        torque = torch.as_tensor(torque, dtype=torch.float32, device=state.device)
        if torque.ndim == 2 and torque.shape[-1] == 1:
            torque = torque[..., 0]
        return state.replace(torque=_set_column(state.torque, self.index, torque))

    def dyn_state(self, state: WorldState):
        return state.dyn[self.slot]


class World:
    """World builder and physics. The constructor parameters mirror VMAS's
    ``World.__init__``; ``device`` places every tensor of the world's state
    (``None`` means the GPU, as for ``make_env``)."""

    def __init__(
        self,
        batch_dim: int,
        device=None,
        dt: float = 0.1,
        substeps: int = 1,
        drag: float = DRAG,
        linear_friction: float = LINEAR_FRICTION,
        angular_friction: float = ANGULAR_FRICTION,
        x_semidim: float = None,
        y_semidim: float = None,
        dim_c: int = 0,
        collision_force: float = COLLISION_FORCE,
        joint_force: float = JOINT_FORCE,
        torque_constraint_force: float = TORQUE_CONSTRAINT_FORCE,
        contact_margin: float = 1e-3,
        gravity: Tuple[float, float] = (0.0, 0.0),
    ):
        assert batch_dim > 0, f"Batch dim must be greater than 0, got {batch_dim}"
        self.batch_dim = batch_dim
        self.device = resolve_device(device)
        self.dt = dt
        self.substeps = substeps
        self.sub_dt = dt / substeps
        self.drag = drag
        self.linear_friction = linear_friction
        self.angular_friction = angular_friction
        self.x_semidim = x_semidim
        self.y_semidim = y_semidim
        self.dim_p = 2
        self.dim_c = dim_c
        self.collision_force = collision_force
        self.joint_force = joint_force
        self.torque_constraint_force = torque_constraint_force
        self.contact_margin = contact_margin
        self.gravity = tuple(np.asarray(gravity, dtype=np.float32).reshape(2))

        # set True (before finalize) to give the state a per-env, per-entity
        # gravity override (WorldState.dyn_gravity)
        self.dynamic_gravity = False
        # set True to run each step through the hand-written fused kernel
        # (core/fused.py); Environment(fused_physics=True) does this
        self.fused = False
        self._agents: List[Agent] = []
        self._landmarks: List[Landmark] = []
        self.spec = None  # set by finalize()

    # -- construction ---------------------------------------------------
    def add_agent(self, agent: Agent):
        assert self.spec is None, "Cannot add entities after finalize()"
        if self.dim_c == 0:
            assert agent.silent, f"Agent {agent.name} must be silent when world has no communication"
        agent._world = self
        agent.dynamics.world = self
        self._agents.append(agent)

    def add_landmark(self, landmark: Landmark):
        assert self.spec is None, "Cannot add entities after finalize()"
        landmark._world = self
        self._landmarks.append(landmark)

    def add_joint(self, joint):
        raise NotImplementedError("joints are not ported to vmas_tpu_torch yet")

    @property
    def agents(self) -> List[Agent]:
        return self._agents

    @property
    def landmarks(self) -> List[Landmark]:
        return self._landmarks

    @property
    def entities(self) -> List[Entity]:
        return self._landmarks + self._agents

    @property
    def policy_agents(self) -> List[Agent]:
        return [a for a in self._agents if a.action_script is None]

    @property
    def scripted_agents(self) -> List[Agent]:
        return [a for a in self._agents if a.action_script is not None]

    # -- finalize: bake everything static ------------------------------
    def finalize(self):
        if self.spec is not None:
            return self
        for i, e in enumerate(self.entities):
            e.index = i
        for s, a in enumerate(self._agents):
            a.slot = s
        self.spec = _physics.build_spec(self)
        return self

    # -- state management ----------------------------------------------
    def spawn_state(self, scenario: dict = None) -> WorldState:
        """Fresh zeroed state on ``self.device``."""
        self.finalize()
        B, E, A = self.batch_dim, len(self.entities), len(self._agents)
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=self.device)
        J = len(self.spec.joint_idx_a)
        return WorldState(
            pos=z(B, E, 2),
            vel=z(B, E, 2),
            rot=z(B, E),
            ang_vel=z(B, E),
            force=z(B, E, 2),
            torque=z(B, E),
            c=z(B, A, self.dim_c),
            u=tuple(z(B, a.action_size) for a in self._agents),
            uc=z(B, A, self.dim_c),
            dyn=tuple(a.dynamics.init_state(B) for a in self._agents),
            joint_fixed_rot=z(B, J),
            rendering=torch.ones((B, E), dtype=torch.bool, device=self.device),
            scenario=scenario if scenario is not None else {},
            dyn_gravity=z(B, E, 2) if self.dynamic_gravity else None,
        )

    def zeroed(self, state: WorldState) -> WorldState:
        """Zero all physical state, keep scenario scratch and rendering."""
        zero = torch.zeros_like
        return state.replace(
            pos=zero(state.pos),
            vel=zero(state.vel),
            rot=zero(state.rot),
            ang_vel=zero(state.ang_vel),
            force=zero(state.force),
            torque=zero(state.torque),
            c=zero(state.c),
            u=tuple(zero(u) for u in state.u),
            uc=zero(state.uc),
            dyn=tuple(a.dynamics.init_state(state.batch_dim) for a in self._agents),
        )

    # -- the hot path ---------------------------------------------------
    def step(self, state: WorldState) -> WorldState:
        """One physics step. Expects the action forces/torques already in
        ``state.force``/``state.torque``. With ``fused`` set, the step runs
        through the fused kernel (core/fused.py; forward only)."""
        if self.fused:
            from vmas_tpu_torch.core import fused as _fused

            if _fused.supports(self):
                return _fused.fused_physics_step(self, state)
        return _physics.physics_step(self, state)

    def step_with_outputs(self, state: WorldState, outputs):
        """Fused physics step that also emits the scenario's output rows
        (fused.FusedOutputs). Returns ``(state, extra_rows)``."""
        from vmas_tpu_torch.core import fused as _fused

        assert self.fused and _fused.supports(self)
        return _fused.fused_physics_step(self, state, outputs)

    def sync_joints(self, state: WorldState) -> WorldState:
        """Joints are not ported; without them there is nothing to sync."""
        return state

    # -- queries ---------------------------------------------------------
    def cast_rays(self, state, entity, angles, max_range, entity_filter=lambda _: False):
        raise NotImplementedError("ray casting is not ported to vmas_tpu_torch yet")

    def cast_ray(self, state, entity, angles, max_range, entity_filter=lambda _: False):
        raise NotImplementedError("ray casting is not ported to vmas_tpu_torch yet")

    def get_distance_from_point(self, state, entity, test_point_pos, env_index=None):
        r = _queries.get_distance_from_point(self, state, entity, test_point_pos)
        return r if env_index is None else r[env_index]

    def get_distance(self, state, entity_a, entity_b, env_index=None):
        r = _queries.get_distance(self, state, entity_a, entity_b)
        return r if env_index is None else r[env_index]

    def is_overlapping(self, state, entity_a, entity_b, env_index=None):
        r = _queries.is_overlapping(self, state, entity_a, entity_b)
        return r if env_index is None else r[env_index]

    def collides(self, a: Entity, b: Entity) -> bool:
        """Static collidability (the runtime broad phase is subsumed by the
        zero-beyond-margin force law)."""
        if a is b or (not a.collides(b)) or (not b.collides(a)):
            return False
        if not a.movable and not a.rotatable and not b.movable and not b.rotatable:
            return False
        shape_pair = {type(a.shape), type(b.shape)}
        allowed = [{Sphere}, {Sphere, Box}, {Sphere, Line}, {Line}, {Line, Box}, {Box}]
        return shape_pair in allowed
