"""The port's wrappers (gym, gymnasium, gymnasium_vec, rllib) and
``make_env(wrapper=...)``: the counterparts of tests/test_wrappers.py:19-107
on the port, the spaces against the JAX package's, and the wrapper argument
reaching the wrapper instead of the scenario."""

import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from vmas_tpu_torch import make_env
from vmas_tpu_torch.environment import Environment, Wrapper
from vmas_tpu_torch.environment.gym_wrappers import GymnasiumVectorizedWrapper, GymWrapper
from vmas_tpu_torch.environment.rllib import VectorEnvWrapper

torch.set_num_threads(1)

# tests/test_wrappers.py's scenarios
SCENARIOS = [
    "balance", "discovery", "give_way", "joint_passage", "navigation",
    "passage", "transport", "waterfall", "simple_world_comm",
]
DICT_SCENARIOS = ["transport", "simple_world_comm"]


def cpu_env(*args, **kwargs):
    return make_env(*args, device="cpu", **kwargs)


@pytest.mark.parametrize("scenario", DICT_SCENARIOS)
def test_gym_wrapper_dict_spaces(scenario):
    env = cpu_env(scenario, num_envs=1, seed=0, wrapper="gym", dict_spaces=True)
    obs = env.reset(seed=0)
    assert isinstance(obs, dict)
    assert set(obs) == {a.name for a in env.env.agents}
    acts = {a.name: np.asarray(u)[0] for a, u in zip(env.env.agents, env.env.get_random_actions())}
    obs, rews, done, info = env.step(acts)
    assert isinstance(obs, dict) and isinstance(rews, dict)
    assert all(isinstance(o, np.ndarray) for o in obs.values())


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("continuous", [True, False])
def test_gym_wrapper(scenario, continuous):
    env = cpu_env(scenario, num_envs=1, seed=0, continuous_actions=continuous, wrapper="gym")
    assert isinstance(env, GymWrapper)
    obs = env.reset(seed=0)
    assert len(obs) == env.env.n_agents
    for o, space in zip(obs, env.observation_space.spaces):
        assert np.asarray(o).shape == space.shape
    acts = [np.asarray(a)[0] for a in env.env.get_random_actions()]
    obs, rews, done, info = env.step(acts)
    assert isinstance(done, bool)
    assert all(isinstance(r, float) for r in rews)
    assert set(info.keys()) == {a.name for a in env.env.agents}


def test_gym_seeded_reset_determinism():
    env1 = cpu_env("transport", num_envs=1, seed=3, wrapper="gym")
    env2 = cpu_env("transport", num_envs=1, seed=3, wrapper="gym")
    np.testing.assert_array_equal(np.asarray(env1.reset(seed=3)[0]), np.asarray(env2.reset(seed=3)[0]))
    other = cpu_env("transport", num_envs=1, seed=3, wrapper="gym").reset(seed=4)
    assert not np.array_equal(np.asarray(other[0]), np.asarray(env1.reset(seed=3)[0]))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_gymnasium_wrapper(scenario):
    env = cpu_env(scenario, num_envs=1, seed=0, wrapper="gymnasium", terminated_truncated=True)
    obs, info = env.reset(seed=0)
    assert env.unwrapped is env.env
    acts = [np.asarray(a)[0] for a in env.unwrapped.get_random_actions()]
    obs, rews, terminated, truncated, info = env.step(acts)
    assert isinstance(terminated, bool) and isinstance(truncated, bool)
    assert all(space.contains(np.asarray(o, np.float32)) for o, space in zip(obs, env.observation_space.spaces))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_gymnasium_vec_wrapper(scenario):
    env = cpu_env(scenario, num_envs=4, seed=0, wrapper="gymnasium_vec", terminated_truncated=True)
    obs, info = env.reset(seed=0)
    assert np.asarray(obs[0]).shape[0] == 4
    acts = [np.asarray(a) for a in env.unwrapped.get_random_actions()]
    obs, rews, terminated, truncated, info = env.step(acts)
    assert np.asarray(terminated).shape == (4,)
    assert env.observation_space.spaces[0].shape == (4,) + env.single_observation_space.spaces[0].shape


def test_gymnasium_vec_wrapper_fused_physics():
    """The wrappers compose with the fused step and its emitted outputs."""
    env = cpu_env("transport", num_envs=4, seed=0, wrapper="gymnasium_vec", terminated_truncated=True,
                  fused_physics=True)
    assert env.unwrapped._fused_outputs is not None
    obs, info = env.reset(seed=0)
    acts = [np.asarray(a) for a in env.unwrapped.get_random_actions()]
    for _ in range(3):
        obs, rews, terminated, truncated, info = env.step(acts)
    assert np.isfinite(np.asarray(obs[0])).all()
    assert np.asarray(terminated).shape == (4,)
    # tensors in, the same as numpy in
    t = env.step(env.unwrapped.get_random_actions())
    assert isinstance(t[0][0], np.ndarray) and t[0][0].shape == (4, 11)


def test_rllib_wrapper():
    """ray is not installed: the wrapper is the plain class of the same
    methods."""
    env = cpu_env("dispersion", num_envs=3, seed=0, wrapper="rllib")
    assert isinstance(env, VectorEnvWrapper) and type(env).__mro__[1] is object
    obs = env.vector_reset()
    assert len(obs) == 3 and len(obs[0]) == env.env.n_agents
    actions = [[np.asarray(a)[j] for a in env.env.get_random_actions()] for j in range(3)]
    obs, rews, dones, infos = env.vector_step(actions)
    assert len(rews) == 3 and isinstance(rews[0], float)
    assert "rewards" in infos[0]
    obs0 = env.reset_at(1)
    assert len(obs0) == env.env.n_agents
    assert env.get_sub_environments() == [env.env] and env.seed(5) == [5]


@pytest.mark.parametrize("wrapper", list(Wrapper), ids=lambda w: w.name.lower())
def test_make_env_wrapper_reaches_the_wrapper(wrapper):
    """make_env returns the wrapper, from the enum or its name, with
    wrapper_kwargs passed on, and warns of nothing (the scenario does not
    see the argument)."""
    vec = wrapper in (Wrapper.GYMNASIUM, Wrapper.GYMNASIUM_VEC)
    kw = dict(terminated_truncated=vec)
    n = 2 if wrapper in (Wrapper.GYMNASIUM_VEC, Wrapper.RLLIB) else 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        by_name = cpu_env("transport", n, wrapper=wrapper.name.lower(), **kw)
        by_enum = cpu_env("transport", n, wrapper=wrapper, **kw)
        no_numpy = cpu_env("transport", n, wrapper=wrapper, **kw,
                           wrapper_kwargs={} if wrapper is Wrapper.RLLIB else {"return_numpy": False})
    assert type(by_name) is type(by_enum) and not isinstance(by_name, Environment)
    assert isinstance(by_name.env, Environment)
    if wrapper is Wrapper.GYMNASIUM_VEC:
        obs, _ = no_numpy.reset(seed=0)
        assert isinstance(obs[0], torch.Tensor)
    assert isinstance(cpu_env("transport", 1), Environment)


def test_spaces_match_the_jax_package():
    """get_action_space / get_observation_space as the JAX package's, and
    the lazy properties give the same spaces."""
    import vmas_tpu

    for kw in (dict(), dict(dict_spaces=True), dict(continuous_actions=False),
               dict(continuous_actions=False, multidiscrete_actions=True)):
        env = cpu_env("simple_world_comm", 2, seed=0, **kw)
        jenv = vmas_tpu.make_env("simple_world_comm", 2, seed=0, **kw)
        assert env.get_action_space() == jenv.get_action_space() == env.action_space
        obs = env.reset()
        assert env.get_observation_space(obs) == jenv.get_observation_space(jenv.reset()) == env.observation_space


def test_vectorized_wrapper_builds_without_its_spaces():
    """The vectorized wrapper builds its spaces only when asked, so that it
    steps where gymnasium is not installed."""
    env = cpu_env("transport", 4, seed=0, terminated_truncated=True)
    w = GymnasiumVectorizedWrapper(env)
    assert env._spaces == {}
    w.step(env.get_random_actions())
    assert env._spaces == {}


def test_wrappers_step_without_gymnasium():
    """Where gymnasium is not installed (as on a GPU machine without it),
    the wrappers still build and step: a fresh interpreter in which the
    import of gymnasium fails."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['gymnasium'] = None; "
            "from vmas_tpu_torch import make_env; "
            "env = make_env('transport', 4, device='cpu', wrapper='gymnasium_vec', terminated_truncated=True); "
            "obs, info = env.reset(seed=0); out = env.step(env.unwrapped.get_random_actions()); "
            "g = make_env('transport', 1, device='cpu', wrapper='gymnasium', terminated_truncated=True); "
            "g.reset(seed=0); "
            "print(type(env).__mro__[1].__module__, obs[0].shape, out[2].shape)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=str(pathlib.Path(__file__).resolve().parent.parent))
    assert out.stdout.split() == ["vmas_tpu_torch.environment.gym_wrappers", "(4,", "11)", "(4,)"], out.stdout
