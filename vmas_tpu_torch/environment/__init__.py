"""The environment and its interop wrappers (counterpart of
vmas_tpu/environment/__init__.py: the ``Wrapper`` enum with its
``get_env`` factory)."""

from enum import Enum

from vmas_tpu_torch.environment.environment import Environment


class Wrapper(Enum):
    GYM = 0
    GYMNASIUM = 1
    GYMNASIUM_VEC = 2
    RLLIB = 3

    def get_env(self, env: Environment, **kwargs):
        if self is self.GYM:
            from vmas_tpu_torch.environment.gym_wrappers import GymWrapper

            return GymWrapper(env, **kwargs)
        elif self is self.GYMNASIUM:
            from vmas_tpu_torch.environment.gym_wrappers import GymnasiumWrapper

            return GymnasiumWrapper(env, **kwargs)
        elif self is self.GYMNASIUM_VEC:
            from vmas_tpu_torch.environment.gym_wrappers import GymnasiumVectorizedWrapper

            return GymnasiumVectorizedWrapper(env, **kwargs)
        elif self is self.RLLIB:
            from vmas_tpu_torch.environment.rllib import VectorEnvWrapper

            return VectorEnvWrapper(env, **kwargs)


__all__ = ["Environment", "Wrapper"]
