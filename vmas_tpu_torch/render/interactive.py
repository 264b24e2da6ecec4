"""Interactive play with keyboard control.

Counterpart of vmas_tpu/render/interactive.py: matplotlib key events drive
the env, arrows + M/N control agent 0, WASD + Q/E control agent 1 (with
control_two_agents=True), TAB/LSHIFT cycle agents, R resets, digits 0-4 set
the comm channel. Each step's actions are host arrays that ``env.step``
moves to the env's device; ``render_interactively`` builds the env on the
GPU unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

import torch

from vmas_tpu_torch.make_env import make_env


class InteractiveEnv:
    def __init__(
        self,
        env,
        control_two_agents: bool = False,
        display_info: bool = True,
        save_render: bool = False,
        render_name: str = "interactive",
    ):
        self.env = env
        self.control_two_agents = control_two_agents
        self.display_info = display_info
        self.save_render = save_render
        self.render_name = render_name
        self.n_agents = env.n_agents
        self.agent_index = 0
        self.agent2_index = 1 if self.n_agents > 1 else None
        self.keys = set()
        self.comm_value = 0
        self.frames = []
        self.reset()

    def reset(self):
        self.total_rew = [0.0] * max(self.n_agents, 1)
        self.env.reset()

    @staticmethod
    def format_obs(obs):
        """Observation rounded to 2 decimals for on-screen display."""
        if isinstance(obs, dict):
            return {key: InteractiveEnv.format_obs(value) for key, value in obs.items()}
        values = obs.tolist() if isinstance(obs, torch.Tensor) else np.asarray(obs).tolist()
        return list(np.around(values, decimals=2))

    def _u_from_keys(self, up, down, left, right, rot_p, rot_m, agent):
        u = np.zeros(agent.action_size, np.float32)
        r = agent.u_range_array
        if agent.action_size > 0:
            if right in self.keys:
                u[0] = r[0]
            if left in self.keys:
                u[0] = -r[0]
        if agent.action_size > 1:
            if up in self.keys:
                u[1] = r[min(1, len(r) - 1)]
            if down in self.keys:
                u[1] = -r[min(1, len(r) - 1)]
        if agent.action_size > 2:
            if rot_p in self.keys:
                u[2] = r[2]
            if rot_m in self.keys:
                u[2] = -r[2]
        return u

    def step(self):
        actions = []
        for i, agent in enumerate(self.env.agents):
            if i == self.agent_index:
                u = self._u_from_keys("up", "down", "left", "right", "m", "n", agent)
            elif self.control_two_agents and i == self.agent2_index:
                u = self._u_from_keys("w", "s", "a", "d", "e", "q", agent)
            else:
                u = np.zeros(agent.action_size, np.float32)
            if self.env.world.dim_c > 0 and not agent.silent:
                c = np.zeros(self.env.world.dim_c, np.float32)
                c[min(self.comm_value, self.env.world.dim_c - 1)] = 1.0
                u = np.concatenate([u, c])
            actions.append(np.tile(u, (self.env.num_envs, 1)))
        return self.env.step(actions)

    def on_key_press(self, event):
        key = event.key
        if key is None:
            return
        if key == "r":
            self.reset()
        elif key == "tab":
            # skip over the second controlled agent
            self.agent_index = (self.agent_index + 1) % self.n_agents
            if self.control_two_agents and self.agent_index == self.agent2_index:
                self.agent_index = (self.agent_index + 1) % self.n_agents
        elif key == "shift":
            if self.agent2_index is not None:
                self.agent2_index = (self.agent2_index + 1) % self.n_agents
                if self.control_two_agents and self.agent2_index == self.agent_index:
                    self.agent2_index = (self.agent2_index + 1) % self.n_agents
        elif len(key) == 1 and key in "01234":
            self.comm_value = int(key)
        else:
            self.keys.add(key)

    def on_key_release(self, event):
        self.keys.discard(event.key)

    def run(self, max_steps: int = 10_000):
        import matplotlib.pyplot as plt

        plt.ion()
        connected_fig = None
        for _ in range(max_steps):
            obs, rews, dones, infos = self.step()
            # draws into the env's persistent live window AND returns the
            # frame (viewer.render_env visualize_when_rgb)
            frame = self.env.render(mode="rgb_array", visualize_when_rgb=True)
            if self.save_render:
                self.frames.append(frame)
            fig = getattr(self.env, "_render_fig", None) or plt.gcf()
            if fig is not connected_fig:
                # connect handlers once per figure, not once per frame
                fig.canvas.mpl_connect("key_press_event", self.on_key_press)
                fig.canvas.mpl_connect("key_release_event", self.on_key_release)
                connected_fig = fig
            if self.display_info:
                from vmas_tpu_torch.utils import extract_nested_with_index

                r = float(rews[self.agent_index][0])
                self.total_rew[self.agent_index] += r
                d = bool(dones[0])
                # obs/rew/total/done readout for the controlled agent
                obs_str = str(
                    self.format_obs(extract_nested_with_index(obs[self.agent_index], 0))
                )
                if len(obs_str) > 160:
                    obs_str = obs_str[:157] + "..."
                fig.suptitle(
                    f"agent {self.agent_index}  rew {r:+.3f}  "
                    f"total {self.total_rew[self.agent_index]:+.2f}  done {d}  "
                    f"comm {self.comm_value}\nObs: {obs_str}",
                    fontsize=8,
                )
            plt.pause(0.05)
            if bool(dones[0]):
                # episode end restarts play and zeroes the running totals
                self.reset()
        if self.save_render and self.frames:
            from vmas_tpu_torch.render.video import save_video

            save_video(self.render_name, self.frames, fps=1 / self.env.world.dt)


def render_interactively(
    scenario,
    control_two_agents: bool = False,
    display_info: bool = True,
    save_render: bool = False,
    device=None,
    **kwargs,
):
    """Play ``scenario`` (a name, or a scenario file's path) in one env on
    ``device`` (None: the GPU), with the keys of :class:`InteractiveEnv`;
    ``kwargs`` go to ``make_env``."""
    if isinstance(scenario, str) and scenario.endswith(".py"):
        import os

        scenario = os.path.basename(scenario)[:-3]
    env = make_env(scenario=scenario, num_envs=1, device=device, seed=0, **kwargs)
    InteractiveEnv(
        env,
        control_two_agents=control_two_agents,
        display_info=display_info,
        save_render=save_render,
        render_name=str(scenario),
    ).run()


def parse_args(argv=None):
    """The command line's flags."""
    from argparse import ArgumentParser, BooleanOptionalAction

    parser = ArgumentParser(description="Interactive rendering")
    parser.add_argument(
        "--scenario", type=str, default="waterfall",
        help="Scenario to load (a name from vmas_tpu_torch.scenarios)",
    )
    parser.add_argument(
        "--control_two_agents", action=BooleanOptionalAction, default=True,
        help="Whether to control two agents or just one",
    )
    parser.add_argument(
        "--display_info", action=BooleanOptionalAction, default=True,
        help="Display name/reward/total reward/done/observation of the first "
             "controlled agent",
    )
    parser.add_argument(
        "--save_render", action="store_true",
        help="Save a video of the render up to the first reset",
    )
    parser.add_argument(
        "--device", type=str, default=None,
        help="Device of the env (default: the GPU; 'cpu' to play without one)",
    )
    return parser.parse_args(argv)


def main(argv=None):
    """Play the scenario the command line names: TAB/LSHIFT switch agents,
    R resets, arrows + M/N drive agent one, WASD + Q/E drive agent two,
    digits set comm channels."""
    args = parse_args(argv)
    render_interactively(
        scenario=args.scenario,
        control_two_agents=args.control_two_agents,
        display_info=args.display_info,
        save_render=args.save_render,
        device=args.device,
    )


if __name__ == "__main__":
    main()
