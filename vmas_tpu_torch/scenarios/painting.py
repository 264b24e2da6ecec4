"""Painting: agents carry a colour (their knowledge), mix it with the
colours the others broadcast, and reach the goal that expects their colour.

Counterpart of vmas_tpu/scenarios/painting.py. Each agent's knowledge ``[B,
2, K]``, each goal's expected knowledge ``[B, K]`` and the seeking flags
live in scratch through the DOTS handles (dots_core.py); the shaping
baselines and reward terms are ``[B, A]`` and ``[B, A, G]`` scratch tensors.
The seaborn "Set2" palette is inlined. No fused outputs, as in the JAX
package: with ``fused_physics=True`` the fused step runs with no emit and
the hooks run around it.

The quirks are the JAX package's and are kept: ``mix_knowledge`` reads the
other agents' comm *state* (the previous step's broadcast), the goal test
is ``(0 < d) == (d < r / 2)``, the stored seeking flags keep their reset
value (``pre_rewards`` merges its scratch back over the updated flags), and
the comms network's reward is the final reward.
"""

from __future__ import annotations

import numpy as np
import torch

from vmas_tpu_torch.core import Box, Color, Sphere
from vmas_tpu_torch.core.utils import safe_norm
from vmas_tpu_torch.dots_core import DOTSAgent, DOTSComsNetwork, DOTSPayloadDest, DOTSWorld
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.utils import ScenarioUtils

# seaborn Set2 palette (8 colours)
SET2 = (
    (0.4, 0.7607843137254902, 0.6470588235294118),
    (0.9882352941176471, 0.5529411764705883, 0.3843137254901961),
    (0.5529411764705883, 0.6274509803921569, 0.796078431372549),
    (0.9058823529411765, 0.5411764705882353, 0.7647058823529411),
    (0.6509803921568628, 0.8470588235294118, 0.32941176470588235),
    (1.0, 0.8509803921568627, 0.1843137254901961),
    (0.8980392156862745, 0.7686274509803922, 0.5803921568627451),
    (0.7019607843137254, 0.7019607843137254, 0.7019607843137254),
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.task_type = kwargs.get("task_type", "nav")
        self.n_agents = kwargs.get("n_agents", 4)
        self.n_goals = kwargs.get("n_goals", 4)
        self.agent_radius = 0.2
        self.arena_size = 5
        self.viewer_zoom = 1.7
        self.knowledge_shape = kwargs.get("knowledge_shape", (2, 3))
        self.multi_head = kwargs.get("multi_head", False)
        self.observation_proximity = kwargs.get("observation_proximity", self.arena_size)
        self.observe_all_goals = kwargs.get("observe_all_goals", False)
        self.observe_other_agents = kwargs.get("observe_other_agents", True)
        self.isolated_coms = kwargs.get("isolated_coms", False)
        self.coms_proximity = kwargs.get("coms_proximity", self.arena_size)
        self.learn_coms = kwargs.get("learn_coms", True)
        self.mixing_thresh = kwargs.get("mixing_thresh", 0.01)
        self.learn_mix = kwargs.get("learn_mix", True)
        self.dim_c = kwargs.get("dim_c", 1 + self.knowledge_shape[1]) if self.task_type != "nav" else 0
        self.agent_action_size = kwargs.get("action_size", 2 + self.knowledge_shape[1])

        world = DOTSWorld(batch_dim, device, collision_force=100, dim_c=self.dim_c)
        self.agent_list = []
        name_ext = ["nav_", "mix_"] if self.multi_head else [""]
        for ext in name_ext:
            for i in range(self.n_agents):
                agent = DOTSAgent(
                    name=f"{ext}agent_{i}",
                    shape=Sphere(self.agent_radius),
                    color=Color.GREEN,
                    knowledge_shape=self.knowledge_shape,
                    silent=True if self.dim_c == 0 else False,
                    action_size=self.agent_action_size,
                )
                self.agent_list.append(agent)
                world.add_agent(agent)

        self.coms_network = None
        if self.isolated_coms:
            self.coms_network = DOTSComsNetwork(name="coms_network", action_size=self.dim_c * self.n_agents)
            world.add_agent(self.coms_network)

        self.goals = []
        for i in range(self.n_goals):
            goal = DOTSPayloadDest(
                name=f"goal_{i}", collide=False,
                shape=Box(length=self.agent_radius * 4, width=self.agent_radius * 4),
                color=Color.BLUE, expected_knowledge_shape=3,
            )
            self.goals.append(goal)
            world.add_landmark(goal)

        world.spawn_map()

        self.agent_collision_penalty = kwargs.get("agent_collision_penalty", -0.2)
        self.env_collision_penalty = kwargs.get("env_collision_penalty", -0.2)
        self.min_collision_distance = kwargs.get("collision_dist", 0.005)
        self.pos_shaping = kwargs.get("pos_shaping", False)
        self.pos_shaping_factor = kwargs.get("pos_shaping_factor", 1.0)
        self.mix_shaping = kwargs.get("mix_shaping", False)
        self.mix_shaping_factor = kwargs.get("mix_shaping_factor", 1.0)
        self.all_on_goal = kwargs.get("final_pos_reward", 0.05)
        self.all_mixed = kwargs.get("final_mix_reward", 0.05)
        self.per_agent_reward = kwargs.get("per_agent_reward", False)
        return world

    # ------------------------------------------------------------------
    def random_paint_generator(self, state, generator):
        """(agent knowledge [B, n_agents, 3], goal knowledge [B, n_goals,
        3]). In "nav", each env's n distinct Set2 colours, shared by the
        agents and the goals; else a linear RGB ramp for the agents and
        uniform colours in [0.01, 1) for the goals."""
        B, dev = state.batch_dim, state.device
        if self.task_type == "nav":
            n = max(self.n_agents, self.n_goals)
            # per env a random permutation of the palette
            perm = torch.argsort(torch.rand((B, len(SET2)), generator=generator, device=dev), dim=1)
            colors = torch.tensor(SET2, dtype=torch.float32, device=dev)[perm[:, :n]]  # [B, n, 3]
            return colors, colors
        t = np.linspace(-510, 510, self.n_agents)
        ramp = np.round(np.clip(np.stack([-t, 510 - np.abs(t), t], axis=1), 0, 255)).astype(np.float32) / 255
        agent_knowledge = torch.tensor(ramp, device=dev)[None].expand(B, self.n_agents, 3)
        goal_knowledge = torch.rand((B, self.n_goals, 3), generator=generator, device=dev) * (1.0 - 0.01) + 0.01
        return agent_knowledge, goal_knowledge

    def reset_world_at(self, state, generator):
        B, dev = state.batch_dim, state.device
        state = ScenarioUtils.spawn_entities_randomly(
            self.agent_list + self.goals, self.world, state, generator,
            min_dist_between_entities=1,
            x_bounds=(int(-self.arena_size / 2), int(self.arena_size / 2)),
            y_bounds=(int(-self.arena_size / 2), int(self.arena_size / 2)),
        )
        for a in self.agent_list:
            state = a.spawn_dots_state(state)
        for g in self.goals:
            state = g.spawn_dots_state(state)

        agent_knowledge, goal_knowledge = self.random_paint_generator(state, generator)
        for i, agent in enumerate(self.agent_list):
            k = agent_knowledge[:, i % self.n_agents, None, :].repeat(1, 2, 1)
            state = agent.set_knowledge(state, k)
        for i, goal in enumerate(self.goals):
            state = goal.set_expected_knowledge(state, goal_knowledge[:, i % self.n_goals, :])

        scratch = dict(state.scenario)
        A = len(self.agent_list)
        shaping = torch.stack(
            [torch.stack([safe_norm(a.pos(state) - g.pos(state)) for g in self.goals], dim=-1)
             for a in self.agent_list],
            dim=1,
        ) * self.pos_shaping_factor  # [B, A, G]
        mix_shaping = torch.stack(
            [torch.stack([safe_norm(a.knowledge(state)[:, 1, :] - g.expected_knowledge(state)) for g in self.goals],
                         dim=-1)
             for a in self.agent_list],
            dim=1,
        ) * self.mix_shaping_factor
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        scratch["shaping"] = shaping
        scratch["pos_shape_norm"] = shaping
        scratch["mix_shaping"] = mix_shaping
        scratch["mix_shaping_norm"] = mix_shaping
        for k in ("final_rew", "final_pos_rew", "final_mix_rew"):
            scratch[k] = z(B)
        for k in ("agent_pos_reward", "agent_mixing_reward", "agent_collision_rew", "obstacle_collision_rew",
                  "agent_final_reward"):
            scratch[k] = z(B, A)
        state = state.replace(scenario=scratch)
        return self.world.reset_map(state)

    # ------------------------------------------------------------------
    def process_action(self, agent, state):
        if self.task_type != "nav" and agent in self.agent_list:
            state = self.mix_knowledge(state, agent)
        return state

    def mix_knowledge(self, state, agent):
        """The agent's mixed colour (knowledge row 1) from its comm action's
        request, the colours in range and its mixing coefficients."""
        i = self.agent_list.index(agent)
        kdims = self.knowledge_shape[-1]
        others = [a for a in self.agent_list if a is not agent]

        comm = state.uc[:, agent.slot]  # the agent's comm action
        request_mix = (comm[:, 0] > 0.5) & ~agent.seeking_goal(state)
        in_prox = (
            torch.stack([safe_norm(agent.pos(state) - o.pos(state)) for o in others], dim=0) < self.coms_proximity
        ) & request_mix[None]
        any_in_prox = torch.zeros_like(request_mix)
        for r in in_prox:
            any_in_prox = any_in_prox | r

        new_mix = agent.knowledge(state)[:, 1, :]
        if self.learn_mix:
            mix_coeff = (agent.u(state)[:, -kdims:] + 1) / 2
        else:
            mix_coeff = self.goals[i % self.n_goals].expected_knowledge(state)

        if self.learn_coms:
            if self.isolated_coms:
                coms_index = i * self.knowledge_shape[1]
                com_knowledge = (self.coms_network.u(state)[:, coms_index: coms_index + kdims] + 1) / 2
            else:
                # the comm STATE, i.e. the previous step's broadcast, not
                # the in-flight comm action
                com_knowledge = torch.stack([state.c[:, o.slot, 1:] for o in others], dim=0)
        else:
            com_knowledge = torch.stack([o.knowledge(state)[:, 0, :] for o in others], dim=0)

        if self.isolated_coms:
            new_mix = com_knowledge * mix_coeff
        else:
            for r in in_prox:
                new_mix = torch.where(r[:, None], 0.0, new_mix)
            for k, r in enumerate(in_prox):
                new_mix = new_mix + torch.where(r[:, None], com_knowledge[k] * mix_coeff, 0.0)
            new_mix = new_mix + torch.where(any_in_prox[:, None], agent.knowledge(state)[:, 0, :] * mix_coeff, 0.0)

        knowledge = agent.knowledge(state).clone()
        knowledge[:, 1, :] = new_mix
        return agent.set_knowledge(state, knowledge)

    # ------------------------------------------------------------------
    def pre_rewards(self, state):
        """Every agent's reward terms and the final rewards, into scratch."""
        scratch = dict(state.scenario)
        B, dev = state.batch_dim, state.device
        A = len(self.agent_list)

        a_pos = state.pos[:, [a.index for a in self.agent_list]]
        g_pos = state.pos[:, [g.index for g in self.goals]]
        dists = safe_norm(a_pos[:, :, None] - g_pos[:, None])  # [B, A, G]
        learnt = torch.stack([a.knowledge(state)[:, 1, :] for a in self.agent_list], dim=1)
        expected = torch.stack([g.expected_knowledge(state) for g in self.goals], dim=1)
        colour_match = safe_norm(learnt[:, :, None] - expected[:, None]) < self.mixing_thresh  # [B, A, G]

        pos_reward = torch.zeros((B, A), dtype=torch.float32, device=dev)
        if self.task_type != "mix":
            if self.pos_shaping:
                pos_shaping = dists * self.pos_shaping_factor
                shaped = (scratch["shaping"] - pos_shaping) / scratch["pos_shape_norm"]
                scratch["shaping"] = pos_shaping
                pos_reward = (shaped * colour_match).sum(-1)
            matched_dists = torch.abs((dists * colour_match).sum(-1))  # [B, A]
            on_goal = (0 < matched_dists) == (matched_dists < self.agent_radius / 2)
            final_reward = torch.where(on_goal, self.all_on_goal / self.n_agents, 0.0)
        else:
            final_reward = torch.zeros((B, A), dtype=torch.float32, device=dev)
        scratch["agent_pos_reward"] = pos_reward
        scratch["agent_final_reward"] = final_reward

        mixing_reward = torch.zeros((B, A), dtype=torch.float32, device=dev)
        if self.task_type != "nav":
            for i, agent in enumerate(self.agent_list):
                gi = i % self.n_goals
                kd = safe_norm(learnt[:, i] - expected[:, gi])
                seeking = agent.seeking_goal(state) | (kd < self.mixing_thresh)
                state = agent.set_seeking_goal(state, seeking)
                if self.mix_shaping:
                    ms = kd * self.mix_shaping_factor
                    shaped = (scratch["mix_shaping"][:, i, gi] - ms) / scratch["mix_shaping_norm"][:, i, gi]
                    mix = scratch["mix_shaping"].clone()
                    mix[:, i, gi] = ms
                    scratch["mix_shaping"] = mix
                    mixing_reward = mixing_reward.clone()
                    mixing_reward[:, i] += shaped
            # this scratch, taken before the loop, wins over the flags the
            # loop set (the JAX package's merge)
            scratch = {**dict(state.scenario), **scratch}
        scratch["agent_mixing_reward"] = mixing_reward

        # collisions
        coll_a = [torch.zeros((B,), dtype=torch.float32, device=dev) for _ in range(A)]
        coll_o = [torch.zeros((B,), dtype=torch.float32, device=dev) for _ in range(A)]
        for i, agent in enumerate(self.agent_list):
            if self.agent_collision_penalty != 0:
                for a in self.agent_list:
                    if a is not agent:
                        hit = self.world.get_distance(state, agent, a) <= self.min_collision_distance
                        coll_a[i] = coll_a[i] + self.agent_collision_penalty * hit.to(torch.float32)
            if self.env_collision_penalty != 0:
                for lm in self.world.walls:
                    if self.world.collides(agent, lm):
                        hit = self.world.get_distance(state, agent, lm) <= self.min_collision_distance
                        coll_o[i] = coll_o[i] + self.env_collision_penalty * hit.to(torch.float32)
        scratch["agent_collision_rew"] = torch.stack(coll_a, dim=-1)
        scratch["obstacle_collision_rew"] = torch.stack(coll_o, dim=-1)

        # the final rewards
        final_rew = torch.zeros((B,), dtype=torch.float32, device=dev)
        if self.task_type != "mix":
            final_pos = final_reward.sum(-1)
            if self.per_agent_reward:
                final_rew = final_rew + final_pos
            else:
                final_pos = torch.where(final_pos < self.all_on_goal, 0.0, final_pos)
                final_rew = final_rew + torch.where(final_pos > 0, self.all_on_goal, 0.0)
            scratch["final_pos_rew"] = final_pos
        if self.task_type != "nav":
            seeking = torch.stack([a.seeking_goal(state) for a in self.agent_list], dim=-1)
            final_mix = (seeking.to(torch.float32) * (self.all_mixed / self.n_agents)).sum(-1)
            if self.per_agent_reward:
                final_rew = final_rew + final_mix
            else:
                final_mix = torch.where(final_mix < self.all_mixed, 0.0, final_mix)
                final_rew = final_rew + torch.where(final_mix > 0, self.all_mixed, 0.0)
            scratch["final_mix_rew"] = final_mix
        scratch["final_rew"] = final_rew
        return state.replace(scenario=scratch)

    def reward(self, agent, state):
        s = state.scenario
        if agent is self.coms_network:
            return s["final_rew"]
        i = self.agent_list.index(agent)
        return (
            s["agent_pos_reward"][:, i]
            + s["agent_mixing_reward"][:, i]
            + s["obstacle_collision_rew"][:, i]
            + s["agent_collision_rew"][:, i]
            + s["final_rew"]
        )

    # ------------------------------------------------------------------
    def observation(self, agent, state):
        if isinstance(agent, DOTSComsNetwork):
            return torch.cat([state.c[:, a.slot] for a in self.agent_list], dim=-1)

        others = (
            torch.stack([safe_norm(agent.pos(state) - a.pos(state)) for a in self.agent_list if a is not agent],
                        dim=1)
            if self.observe_other_agents
            else torch.zeros((state.batch_dim, 0), device=state.device)
        )
        task_obs = [self._goal_observations(state, agent)]
        if self.task_type != "nav":
            self._coms_observations(state, agent, task_obs)
        return torch.cat(
            [
                agent.pos(state),
                agent.vel(state),
                agent.knowledge(state)[:, 0, :],
                agent.knowledge(state)[:, 1, :],
                *task_obs,
                others,
            ],
            dim=-1,
        )

    def _coms_observations(self, state, agent, task_obs):
        if self.isolated_coms:
            i = self.agent_list.index(agent)
            start = self.dim_c * i
            task_obs.append(self.coms_network.u(state)[:, start: start + self.dim_c])
        elif self.learn_coms:
            task_obs.extend(state.c[:, a.slot] for a in self.agent_list if a is not agent)
        else:
            task_obs.extend(a.knowledge(state)[:, 0, :] for a in self.agent_list if a is not agent)

    def _goal_observations(self, state, agent):
        if self.observe_all_goals:
            return torch.cat(
                [torch.cat([g.pos(state) - agent.pos(state), g.expected_knowledge(state)], dim=-1)
                 for g in self.goals],
                dim=-1,
            )
        goal = self.goals[self.agent_list.index(agent) % self.n_goals]
        if self.task_type == "mix":
            return goal.expected_knowledge(state) - agent.knowledge(state)[:, 1, :]
        return torch.cat([goal.pos(state) - agent.pos(state), goal.expected_knowledge(state)], dim=-1)

    def done(self, state):
        return torch.zeros((state.batch_dim,), dtype=torch.bool, device=state.device)

    def info(self, agent, state):
        s = state.scenario
        if isinstance(agent, DOTSComsNetwork):
            return {"final_rew": s["final_rew"]}
        i = self.agent_list.index(agent)
        return {
            "pos_reward": s["agent_pos_reward"][:, i],
            "mix_reward": s["agent_mixing_reward"][:, i],
            "final_rew": s["final_rew"],
        }

    def top_layer_render(self, env, ax, env_index: int = 0):
        """The knowledge above the entities: each goal's expected-knowledge
        colour as a patch, each agent's primary and mixed knowledge as two
        half-discs, and a yellow disc under an agent seeking its goal."""
        from vmas_tpu_torch.render import draw

        state = env.state
        pos = state.pos[env_index].numpy()
        for goal in self.goals:
            col = np.clip(goal.expected_knowledge(state)[env_index].numpy(), 0, 1)
            p = pos[goal.index]
            draw.draw_rect(ax, (p[0] - goal.shape.width / 8, p[1]), goal.shape.width / 4, goal.shape.length / 2, 0.0,
                           col, zorder=4)
        for agent in self.agent_list:
            p = pos[agent.index]
            if bool(agent.seeking_goal(state)[env_index]):
                draw.draw_circle(ax, p, self.agent_radius, (1, 1, 0), filled=True, zorder=4)
            know = np.clip(agent.knowledge(state)[env_index].numpy(), 0, 1)
            # primary on the upper half-disc, mixed on the lower
            draw.draw_wedge(ax, p, self.agent_radius / 2, 0, np.pi, know[0], zorder=5)
            draw.draw_wedge(ax, p, self.agent_radius / 2, np.pi, 2 * np.pi, know[1], zorder=5)
