#!/usr/bin/env python3
"""Smoke run of vmas_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

1. Checks for a GPU and prints its name and power limit (nvidia-smi).
2. Builds the CUDA kernels from vmas_tpu_torch/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version at full width
   (transport, 4096 envs, 4 agents): 20 steps of the rows step and of the
   fused step from one state, re-synced to the kernel's output each step;
   then the env.step rollout against the rows rollout over a short horizon.
4. Drives the main path with the launch counts zeroed: make_env on the
   GPU, reset, 5 env.step calls, then rows_rollout_fn(horizon=1000) once
   to warm up and 3 timed calls; checks the shapes, finiteness and launch
   counts, and prints env-steps/s.
5. balance at 4096 envs (3 agents): the rows step and the fused step
   against their plain versions for 20 re-synced steps from a state in
   which its four contact types (ss, ls, bs, bl) touch, with the contacts
   per type; the all-pairs world (6 spheres, 2 lines, 3 boxes: all six
   contact types) stepped by the fused kernel against its plain version for
   20 re-synced steps from a packed state; then balance's main path with
   the counts zeroed: make_env, reset, 5 env.step calls, rows_rollout_fn
   (horizon 1000) once to warm up and 3 timed calls, env-steps/s and the
   device idle share.
6. joints at 4096 envs: joint_passage's rows step and fused step against
   their plain versions for 10 re-synced steps from a state in which its
   four contact types (ss, ls, bs, bl) touch and every joint is pulled
   apart, with the contacts per type and the lanes with a joint force,
   then its env.step rollout against its rows rollout; waterfall's two
   forms against their plain versions for 5 re-synced steps from a pile in
   which all six types touch and its fixed-rotation torques act; then
   joint_passage's main path with the counts zeroed: make_env (every
   default), reset, 5 env.step calls, rows_rollout_fn (horizon 1000) once
   to warm up and 3 timed calls, env-steps/s and the device idle share.
7. give_way at 4096 envs: the rows step with the in-kernel PID velocity
   controller (K2) and the fused step (K1) against their plain versions for
   20 re-synced steps, for give_way and multi_give_way, from states in which
   the agents touch each other and the walls, with actions that drive the
   PID's clamp, min_input_norm zeroing, memory reset and integrator cutoff
   (the lanes of each are counted); joint_passage with its controller, K2
   against plain for 5 steps; one launch of 4 env steps against 4 launches
   of one, bitwise, and against the plain version's 4 steps, at transport
   and give_way; give_way's env.step rollout against its rows rollout,
   bitwise in rewards, dones, observations, the final state, u and the
   controller memory; then give_way's main path with the counts
   zeroed: make_env, reset, 5 env.step calls, rows_rollout_fn (horizon 1000)
   at k_steps 1 and at k_steps 4, each once to warm up and 3 timed calls,
   env-steps/s and the device idle share; and transport's rows rollout at
   k_steps 1 and 4 side by side.
8. road_traffic at 4096 envs x 20 vehicles (map 1): each road_traffic kernel's
   registers, stack and spills; the path-sweep kernel's group form and the
   all-ego observation kernel's tile form, as the scenario runs them,
   bitwise against their one-thread forms and against their plain versions
   (after a reset, after 20 random steps, and on lanes placed on path
   vertices and padded tails); both forms' device time in turns (one-thread,
   default, default, one-thread); then its main path with the counts zeroed:
   make_env with every default, reset, 5 env.step calls,
   rollout_fn(horizon=100) once to warm up and 3 timed calls, with one
   launch of each kernel per step and reset; its idle share and device
   operations a step from a traced call of 5 steps (the profiler costs
   the host ~0.45 ms a device operation, and a step has ~2800). Then map 2
   (4096 x 20), testing mode (4096 x 20), map 3 (4096 x 10, its default
   sub-map probabilities) and map 3 with [0.4, 0.3, 0.3] (4096 x 4): both
   kernels against their one-thread forms and plain versions after a reset
   and after 10 random steps from testing.rt_events_state (collisions, and
   agents at their exits and entries or across their lanes); the ISB
   records, in-step resets and dones counted over those steps and one timed
   rollout_fn call of 100 steps, and required where the configuration has
   them; the launches of that call, two sweeps a step in map 3 and testing
   mode; each kernel's device time and its plain version's.
9. wind_flocking at 4096 envs: its fused step with the dynamic-gravity rows
   against its plain version, bitwise, on the rows of 10 env.step calls
   from a state with the big agent's wind weakened and the agents touching
   (the lanes of a weakened wind are counted); then its main path with the
   counts zeroed: make_env (every default: 2 agents, the PID on), reset,
   rollout_fn(horizon=100) once to warm up and 3 timed calls, one fused
   step per env.step.
10. MPE: simple_spread's rows and fused steps against their plain versions,
   bitwise, over 10 re-synced steps at 4096 envs and 3 at 30000 from a
   state with overlapping agents, simple's (no contact pair) over 10 at
   4096; one launch of 4 steps against 4 launches of one and the plain
   version's 4 steps, bitwise; simple_spread's env.step rollout against its
   rows rollout with discrete actions, bitwise; then simple_spread's main
   path (3 agents, discrete actions) at 4096 envs (horizon 1000) and 30000
   envs (horizon 100), each at k_steps 1 and 4: make_env, reset, 5 env.step
   calls, rows_rollout_fn once to warm up and 3 timed calls, env-steps/s
   and the device idle share.
11. The rest of the MPE family at 4096 envs (simple_tag, simple_world_comm,
   simple_push, simple_adversary, simple_reference, simple_speaker_listener
   at their defaults): each world's rows and fused steps against their
   plain versions, bitwise, over 5 re-synced steps from a state with
   catches, contacts and food in reach (the contacts, catches and food
   eaten counted), at the rule's lanes and at the other form, and a launch
   of 4 steps against 4 launches of one and the plain version's 4 steps;
   the env.step rollout against the rows rollout over 20 steps for
   simple_tag, simple_world_comm and simple_reference (the comm state
   substituted per step), and simple_reference's env.step policy rollout
   against its rows policy rollout with continuous comm from a linear
   policy, bitwise; then each world's main path with the counts zeroed:
   make_env, reset, 5 env.step calls, rows_rollout_fn (horizon 1000 for
   simple_tag and simple_world_comm, 100 for the others) at k_steps 1 and
   4, once to warm up and 3 timed calls, env-steps/s and the device idle
   share; and simple_crypto's (unfused: rollout_fn, 100 steps, no kernel
   launch).
12. The other holonomic worlds at 4096 envs (reverse_transport, wheel,
   passage, dispersion, dropout and het_mass at their defaults): each
   world's rows step (but het_mass's: it has none) and fused step against
   their plain versions, bitwise, over 5 re-synced steps from
   testing.holonomic_state, with the contacts and events counted (and
   required: box-sphere contacts, line-sphere contacts, passage's wall and
   agent hits, food and goal eaten), at the rule's lanes and at the other
   form, and a launch of 4 steps against 4 launches of one and the plain
   version's 4 steps; dispersion's and dropout's rows rollouts (post_rewards
   once at the end; each step's u read by unpack) and wheel's rows policy
   rollout with its HeuristicPolicy against their env.step rollouts over 20
   steps, bitwise; then each world's main path with the counts zeroed:
   make_env, reset, 5 env.step calls, rows_rollout_fn (horizon 1000 for
   passage and reverse_transport, 100 for the others) at k_steps 1 and 4,
   once to warm up and 3 timed calls, env-steps/s and the device idle
   share (het_mass: rollout_fn, K1 per step). Then the lifted caps:
   simple_spread with 30 agents (60 entities), balance with 17 agents and
   simple_tag with 6 good agents and 12 adversaries, each rows step and
   fused step bitwise its plain version over 3 re-synced steps and timed,
   and each world's main path (5 env.step calls, rows_rollout_fn at 50
   steps); the caps and the by-value parameters' size.
12b. The joint worlds at 4096 envs (buzz_wire, ball_trajectory,
   ball_passage and joint_passage_size at their defaults, and
   joint_passage_size with its velocity controller): each world's rows
   step (the PID in the kernel for the controller config) and fused step
   against their plain versions, bitwise, over 5 re-synced steps from
   testing.joint_worlds_state, with the contacts, joint-force lanes, line
   and box hits, just_passed and done counted (and required), at the
   rule's lanes and at the other form, and a launch of 4 steps against 4
   launches of one and the plain version's 4 steps; asym_joint's fused
   step with no emit bitwise its plain version on the rows of 5 env.step
   calls; each world's rows rollout against its env.step rollout over 20
   steps, bitwise (joint_passage_size's t clock at its start value plus
   the horizon); the noisy configs (give_way's observation noise,
   joint_passage's and joint_passage_size's joint-angle and observation
   noise, simple_spread with action noise, simple_reference with action
   and comm noise) on both rows paths against rollout_fn, bitwise, at
   k_steps 1 and 4, with resets every 10 steps and with a linear policy;
   then each world's main path with the counts zeroed: make_env, reset, 5
   env.step calls, rows_rollout_fn (horizon 1000) at k_steps 1 and 4
   (joint_passage_size with its controller at 1), once to warm up and 3
   timed calls, env-steps/s and the device idle share; asym_joint through
   rollout_fn (100 steps, K1 with no emit per step).
12c. The sensor worlds at 4096 envs (navigation, flocking, discovery at
   their defaults and discovery with a shared reward, a collision penalty
   and no respawn): each emit's fused step, and navigation's and
   flocking's rows step (flocking's target on the action rows), against
   their plain versions, bitwise, over 5 re-synced steps from
   testing.sensor_state at one thread and at 8 lanes per env, with agents
   on their goals, collision hits, covered targets and covering agents
   counted (and required), and a launch of 4 steps against 4 launches of
   one; the Lidar's rays on the card against the same plain code on the
   CPU (atol 2e-5); navigation's rows rollout with its Lidar (each step's
   state rebuilt from its carry rows) over 1000 steps, navigation without
   its Lidar at k_steps 1 and 4, flocking's rows rollout and navigation's
   HeuristicPolicy on the rows policy rollout, each bitwise its env.step
   rollout; pollock at its defaults (45 entities, the plain physics)
   through rollout_fn, 20 steps, its vectorized Lidar against its per-ray
   loop; then the main paths with the counts zeroed: navigation and
   flocking on rows_rollout_fn (horizon 1000, k_steps 1, with the Lidar
   rebuild's share of a call), discovery's two configs on rollout_fn (100
   steps), env-steps/s and the device idle share.
12d. Football at 4096 envs (the red AI's default, both teams as policies,
   and both teams with shooting): its emit's fused step (both fused
   configs) and, for both teams, its rows step with the ball's script in
   the kernel, against their plain versions, bitwise, over 5 re-synced
   steps from testing.football_state at one thread and at 8 lanes per env,
   with goals of each team, live agent shaping, line-sphere contacts,
   non-zero impulses and x impulses zeroed in the goal mouth counted (and
   required), and a launch of 4 steps against 4 launches of one; the
   shooting config's fused step (no emit, the torque rows of its
   HolonomicWithRotation agents) against its plain version; both teams'
   rows rollout at k_steps 1 and 4 and rows policy rollout (a linear
   policy) against rollout_fn, bitwise, final state and the ball's u
   included; then the main paths with the counts zeroed: both teams on
   rows_rollout_fn (horizon 1000, k_steps 1 and 4, with the peak device
   memory) and on rollout_fn (100 steps, the rows path's ratio to it), the
   red AI's default and the shooting config on rollout_fn (50 steps, one
   timed call; their idle shares from a traced call of 10 steps),
   env-steps/s and the device idle share.
12e. The dynamics and controller debug worlds at 4096 envs (diff_drive,
   kinematic_bicycle, drone, goal, vel_control, circle_trajectory and
   line_trajectory at their defaults; none has fused outputs): each
   world's fused step with no emit against its plain version, bitwise, at
   one thread and at 8 lanes per env, over 5 steps from
   testing.debug_world_state, each step's input rows those the step's
   hooks make (the dynamics models' and the controllers' forces and
   torques) and the env stepped on through the kernel, with box-box
   contacts (kinematic_bicycle), torque rows (diff_drive, drone) and
   forces beyond an agent's f_range (the controller worlds) counted and
   required; each world's main path with the count zeroed: make_env,
   reset, 5 env.step calls, rollout_fn (horizon 100) once to warm up and 3
   timed calls, one fused step per env.step, env-steps/s, the idle share
   and device operations a step of a traced call of 10 steps, and the
   drone's u at its spawn width after the rollout; then the grouped
   process_action against the per-agent loop: transport's four holonomic
   agents and football's two teams with the default grouping over 20
   steps, bitwise, and road_traffic's 20 kinematic bicycles under
   VMAS_TPU_BATCH_DYNAMICS=1 over 5 steps (bitwise or its largest
   difference, and the process_action phase's ms a step against the
   loop's, in turns).
12f. painting (nav and task_type "full"), construction and sampling at
   4096 envs (none has fused outputs): each world's fused step with no
   emit against its plain version, bitwise, at one thread and at 8 lanes
   per env, over 5 steps from testing.dots_world_state (agents pressed into
   the walls, or sampling's bound, and into each other; the sphere-sphere
   and box-sphere contacts, or the lanes beyond the bound, counted and
   required), the env stepped on through the kernel; sampling's
   observations, rewards and visited cells over those steps bitwise a twin
   env's stepped through the plain version, and its samples and visited
   cells on the card bitwise the CPU's; each world's main path with the
   count zeroed: make_env, reset, 5 env.step calls, rollout_fn (horizon
   100) once to warm up and 3 timed calls, env-steps/s, the idle share and
   device operations a step of a traced call of 5 steps (painting's step
   has ~2,700 device operations, at ~0.45 ms of host time each under the
   profiler).
12g. The gymnasium vectorized wrapper (make_env(..., wrapper="gymnasium_vec"))
   over transport@4096 with the fused step: reset and 5 steps, numpy
   outputs of the expected shapes, finite.
12h. Rendering at 4096 envs, run after 4 (the profiler's records of a
   frame's one small copy are whole early in the process and lost later):
   transport after 10 steps of rows_rollout_fn (K2), at env 0 and 4095;
   each world with render hooks (testing.RENDER_HOOK_WORLDS, road_traffic
   at its defaults: K3/K4) after 2 env.step calls, fused where the world
   takes it (K1), at env 0; flocking with its Lidar fans, force arrows and
   a position function (its Lidar measured on the card against the frame's
   host copy, atol 2e-5) and simple_reference's comm text; the launches of
   each path with its counts zeroed. Each frame's host copy
   (render/viewer.py host_state) bitwise interop's copy of the same row,
   timed, and timed against the same row taken one .cpu() a leaf; the
   frame (its host copy where nothing is drawn) must make exactly one
   synchronizing CUDA operation (torch's sync debug mode counts them: its
   one device-to-host copy), and the profiler's memcpy records must show
   no more copies than that (a session that lost them is taken again, and
   said so). Each hook world's hooks run on the card's env with
   matplotlib's calls recorded (testing.hook_calls): no synchronizing
   operation, the calls bitwise those of a CPU twin env on the same host
   copy, the artists they add, their host ms. Where matplotlib is
   installed, each frame bitwise the frame of the same state copied to a
   CPU env, its draw ms, the hooks' drawn artists equal to the recorded
   ones, the gymnasium vectorized wrapper's render and rllib's
   try_render_at against their env's frames, and 10 frames through
   save_video; where it is not (find_spec decides), one line says so, and
   env.render and both wrappers' must raise an ImportError naming
   matplotlib. Each phase prints its seconds, and the script its total.
13. The op-cost probe: its kernel against its plain version at [54, 4096]
   with 0, 100 and 1200 operations (the ALU chain bitwise, the
   transcendental chain within atol 1e-6 rtol 1e-5), then its path with
   the count zeroed (tools/time_opcost.py's op sweep: 0 to 1200 operations),
   the slope per operation and the intercept.
14. PPO at transport@4096, 4 agents (bench.py's training half): the rows
   policy rollout (K2 per step) against the env.step policy rollout (K1 per
   step) with policy_aux over 20 steps from one state and one seed, bitwise
   in rewards, dones, observations, raw samples, log-densities and the
   final state; each kernel against its plain version for 5 re-synced
   steps at the policy's actions; then, with the counts zeroed before each:
   rows_policy_rollout_fn at horizon 1000 once to warm up and 4 timed calls
   (1000 K2 launches a call, no K1), env-steps/s and the device idle share;
   8 PPO updates a block (collect="rows", horizon 128, 4 epochs) in bf16
   and in f32, one warm-up block and 3 timed blocks (128 K2 launches an
   update), env-steps/s, the idle share of one update, the loss and the
   parameters finite and moved; 2 updates with collect="step" (128 K1
   launches an update).
15. Utilities and sharding at transport@4096 (4 agents, fused): 10 rows
   steps (K2), save_env, 10 more; a fresh env load_env's the checkpoint and
   takes the same 10, bitwise, with npz and with dcp, the save and load ms
   and the bytes; checked_step on K1 bitwise a twin's env.step over 5 steps
   (ms a step against env.step's), and the NaN and Inf position states
   raise; trace() around 5 K2 launches writes a Chrome trace naming K2's
   kernel; two gloo ranks spawned on this card (parallel.mesh.spawn_ranks,
   vmas_tpu_torch.testing's worker), 2048 envs each: 20 steps of the rows
   policy rollout under a policy that draws nothing, each rank's rows
   bitwise the single-process run's, with no collective, then one learner
   step on the plain path with the parameters equal across ranks, a
   sharded fit and a sharded checkpoint (npz and dcp) that replays; a
   one-rank NCCL mesh: an all-reduce through it and one PPO update on the
   distributed env; the speed_sweep example at 4096 and 30000 envs and
   train_ppo for 2 iterations. Each K1/K2 path of the phase has its kernel
   held bitwise to the plain version and timed (entries
   rows_step[transport,checkpoint], fused_step[transport,checked_step],
   rows_step[transport,rank]).
16. Prints one JSON line describing each kernel, then the result line.

Each kernel's plain version is timed over up to 20 calls, fewer where they
would pass PLAIN_BUDGET_MS (at least PLAIN_MIN_CALLS); the host-bound
rollout_fn paths of discovery's two configs, asym_joint, het_mass and
simple_crypto are timed over their full horizons and traced over
HOOK_TRACE_STEPS steps.

Any failure raises and exits non-zero. It imports nothing of JAX.
"""

import json
import math
import subprocess
import sys
import time

NUM_ENVS = 4096
N_AGENTS = 4
HORIZON = 1000
TIMED_CALLS = 3
CMP_STEPS = 20
# the card's published peaks (H100 SXM data sheet): HBM bytes/s, f32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# road_traffic: the JAX package's measured width; steps compared and run;
# distances and observation values, kernel against plain (both IEEE f32
# without FMA contraction: an ulp or two of cos/sin/sqrt apart at most)
RT_AGENTS = 20
RT_CMP_STEPS = 20
RT_STEPS = 5
RT_HORIZON = 100
# the steps of the main path's traced call: the profiler costs the host
# some 0.45 ms a device operation, and a road_traffic step has ~2800
RT_TRACE_STEPS = 5
RT_ATOL = 1e-6
# operation counts: +, -, *, /, sqrt and a compare count 1; cos and sin 20
TRIG_OPS = 20
# joints: steps compared (their plain versions take a few hundred ms per
# step at 4096 envs) and plain-version calls timed
JP_CMP_STEPS = 10
WF_CMP_STEPS = 5
WF_PLAIN_CALLS = 5
# give_way: steps compared (give_way and multi_give_way, then joint_passage
# with its controller), and the env steps per rows launch timed beside one
GW_CMP_STEPS = 20
JPC_CMP_STEPS = 5
K_STEPS = 4
# wind_flocking: env.step calls compared, and the main path's horizon
WFL_CMP_STEPS = 10
WFL_HORIZON = 100
# MPE: steps compared; simple_spread's second width and its horizon (the
# original VMAS protocol: up to 30,000 envs, 100 steps)
MPE_CMP_STEPS = 10
MPE_WIDE = 30000
MPE_WIDE_HORIZON = 100
# the rest of the MPE family: steps compared from a state with catches and
# contacts, steps of the rollouts compared, and the main paths' horizons
# (the two worlds of many contact pairs at the bench's 1000, the others at
# the VMAS protocol's 100)
MPEF_WORLDS = ("simple_tag", "simple_world_comm", "simple_push", "simple_adversary", "simple_reference",
               "simple_speaker_listener")
MPEF_LONG = ("simple_tag", "simple_world_comm")
MPEF_CMP_STEPS = 5
MPEF_ROLLOUT_STEPS = 20
MPEF_SHORT_HORIZON = 100
# the other holonomic worlds: steps compared from a state with their
# contacts and events, steps of the rollouts compared, and the main paths'
# horizons (the two worlds of many contact pairs and substeps at the bench's
# 1000, the others at 100)
HOL_WORLDS = ("reverse_transport", "wheel", "passage", "dispersion", "dropout", "het_mass")
HOL_LONG = ("passage", "reverse_transport")
HOL_CMP_STEPS = 5
HOL_ROLLOUT_STEPS = 20
HOL_SHORT_HORIZON = 100
# the joint worlds: steps compared from a state with their contacts and
# events, steps of the rollouts compared (the noisy ones too), and the main
# paths' horizons (the four fused worlds at the bench's 1000; asym_joint,
# which runs its hooks around the fused step, at 100)
JW_WORLDS = ("buzz_wire", "ball_trajectory", "ball_passage", "joint_passage_size")
JW_CMP_STEPS = 5
JW_ROLLOUT_STEPS = 20
JW_SHORT_HORIZON = 100
# timed calls of a noisy config at HORIZON on the rows path and on rollout_fn
NOISY_CALLS = 1
# the noisy configs held bitwise on both rows paths: (make_env name, kwargs,
# the agents' noise: "u" action noise, "uc" action and comm noise)
NOISY = {
    "give_way,obs_noise": ("give_way", {"obs_noise": 0.1}, None),
    "joint_passage,joint_angle": ("joint_passage", {"observe_joint_angle": True, "joint_angle_obs_noise": 0.1}, None),
    "joint_passage_size,noise": ("joint_passage_size", {"observe_joint_angle": True, "joint_angle_obs_noise": 0.2,
                                                        "obs_noise": 0.1}, None),
    "simple_spread,u_noise": ("simple_spread", {}, "u"),
    "simple_reference,c_noise": ("simple_reference", {}, "uc"),
}
# the caps: worlds beyond the old caps of 32 entities and 16 agents
CAPS_WORLDS = {
    "simple_spread,30": ("simple_spread", {"n_agents": 30}, "mpe_state"),
    "balance,17": ("balance", {"n_agents": 17}, "balance_contact_state"),
    "simple_tag,6+12": ("simple_tag", {"num_good_agents": 6, "num_adversaries": 12}, "mpe_family_state"),
}
CAPS_CMP_STEPS = 3
# the caps worlds' main-path horizon (simple_spread with 30 agents emits
# 3661 rows a step: 60 MB at 4096 envs)
CAPS_HORIZON = 50
# the op-cost probe: op counts held to the plain version
OPCOST_CHECK_OPS = (0, 100, 1200)
# PPO (bench.py's training half): steps of the bitwise rollout check and of
# the kernels against plain on the path's inputs; collection calls timed
# after one warm-up; updates a block, blocks timed after one warm-up, and
# updates of collect="step"
PPO_CMP_STEPS = 20
PPO_PLAIN_STEPS = 5
COLLECT_CALLS = 4
TRAIN_HORIZON = 128
TRAIN_UPDATES = 8
TRAIN_BLOCKS = 3
STEP_UPDATES = 2


def run_phase(name, fn, *args):
    """``fn(*args)``, printing the seconds it took as the phase ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"the {name} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, n, warm=True):
    """Mean ms per call of ``fn`` over ``n`` back-to-back calls (CUDA events,
    after one warm-up call unless ``warm`` is False)."""
    import torch

    if warm:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


PROFILE_TRIES = 4


def device_ms(fn, n, kernel, per_call=0):
    """Device time per call over ``n`` calls of ``fn``, from torch.profiler:
    ``(ms of kernels whose name holds `kernel`, ms of all device work,
    {kernel name: ms}, number of device operations, number of records whose
    name holds `kernel`)``, each per call; ``kernel`` "" takes all device
    work (a busy-time trace). CUPTI now and then hands a session back with
    no device record, or with some lost, so a session that saw no device
    work, none of ``kernel``, or fewer than ``per_call`` records of it a
    call, is taken again, up to ``PROFILE_TRIES`` sessions in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        by_name, count, records = {}, 0, 0
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / n
                count += 1
                records += kernel in ev.name
        mine = sum(v for k, v in by_name.items() if kernel in k)
        if count and mine > 0 and records >= per_call * n:
            break
        print(f"profiler session {attempt} of {PROFILE_TRIES} saw {count} device records, {records} of {kernel}"
              if count else f"profiler session {attempt} of {PROFILE_TRIES} saw no device record", flush=True)
    return mine, sum(by_name.values()), by_name, count / n, records / n


def launch_ms(fn, n, kernel, name):
    """Device ms per launch of ``kernel`` over ``n`` calls of ``fn``
    (profiler); where no profiler session saw it, the mean ms per call of
    ``n`` back-to-back calls (CUDA events), said so on a line of its own."""
    ms = device_ms(fn, n, kernel)[0]
    if ms > 0:
        return ms
    ms = time_ms(fn, n)
    print(f"{name}: the profiler saw no device time in {PROFILE_TRIES} sessions; its time is "
          f"{ms * 1e3:.3f} us per back-to-back call from CUDA events", flush=True)
    return ms


class ErrTracker:
    """Kernel rows against their plain version's, bitwise: ``close`` raises
    on any difference and keeps the largest absolute error per name (0 on
    every run that passes)."""

    def __init__(self):
        self.err = {}

    def close(self, name, got, want):
        import torch

        diff = (got - want).abs()
        self.err[name] = max(self.err.get(name, 0.0), float(diff.max()) if diff.numel() else 0.0)
        if not torch.equal(got, want):
            n = int((got != want).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"{name}: {n} values differ from the plain version's (max abs err "
                                 f"{self.err[name]:.3e})")
        return self.err[name]

    def max(self):
        return max(self.err.values())

    def report(self):
        for name, v in self.err.items():
            print(f"max abs err {name}: {v:.3e} (bitwise)")


def compare_rows(tr, state_k, state_p, emit_k, emit_p, tag):
    """Kernel against plain for one step's state rows (where ``state_k`` is
    given) and emit rows (observations, rewards, flags, shapings), bitwise."""
    if state_k is not None:
        tr.close(f"{tag} state rows", state_k, state_p)
    tr.close(f"{tag} emit rows", emit_k, emit_p)


def contact_rich(env, gen):
    """The env's state with every env in contact: agents 0 and 1 side by
    side against the package's -x face, the other agents around it at
    contact range, the goal near the package; random rotations, velocities
    and forces. Random actions alone seldom bring an agent to the package
    within a few steps."""
    import torch

    st, sc, dev = env.state, env.scenario, env.device
    B, E = st.pos.shape[:2]
    rnd = lambda *s: torch.rand(s, generator=gen, device=dev)
    nrm = lambda *s: torch.randn(s, generator=gen, device=dev)
    pi, gi = sc.packages[0].index, sc.goal.index
    ai = [a.index for a in env.world.agents]
    pos = torch.zeros((B, E, 2), device=dev)
    pkg = (rnd(B, 2) * 2 - 1) * 0.8
    pos[:, pi] = pkg
    pos[:, gi] = pkg + nrm(B, 2) * 0.15
    pos[:, ai[0]] = pkg + torch.tensor([-0.1, 0.024], device=dev) + nrm(B, 2) * 0.004
    pos[:, ai[1]] = pkg + torch.tensor([-0.1, -0.024], device=dev) + nrm(B, 2) * 0.004
    for a in ai[2:]:
        ang = rnd(B) * 6.283185307179586
        r = 0.1 + nrm(B) * 0.01
        pos[:, a] = pkg + torch.stack([ang.cos(), ang.sin()], -1) * r[:, None]
    return st.replace(
        pos=pos, vel=nrm(B, E, 2) * 0.3, rot=(rnd(B, E) * 2 - 1) * 3.14159,
        ang_vel=nrm(B, E) * 0.2, force=nrm(B, E, 2) * 0.5,
    )


def kernel_entry(name, source, replaces, launches, err, t, nbytes, flops):
    """One kernel's entry of the kernels line: its times ``t`` (ms, wall_ms,
    plain_ms) beside its bound, the larger of bytes over the card's memory
    rate and operations over its f32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    bound = max(t_bytes, t_ops)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        "wall_ms": t["wall_ms"], "us": t["ms"] * 1e3, "plain_us": t["plain_ms"] * 1e3,
        "bound_us": bound * 1e3, "bytes": nbytes, "flops_est": flops,
    }


# instantiations of the fused kernel per lane count the package builds
# (fused.LANES_BUILT): the fused form with no emit and with each of 28, the
# rows form with each of 26 (het_mass and discovery have none)
FUSED_FORMS = 55

# the worlds K1/K2 run here: (make_env name and kwargs) by the name their
# entries of the kernels line carry between brackets
LANE_WORLDS = {
    "transport": ("transport", {"n_agents": N_AGENTS}), "balance": ("balance", {}),
    "joint_passage": ("joint_passage", {}), "joint_passage+pid": ("joint_passage", {"use_controller": True}),
    "waterfall": ("waterfall", {}), "give_way": ("give_way", {}), "multi_give_way": ("multi_give_way", {}),
    "wind_flocking": ("wind_flocking", {}), "simple": ("simple", {"continuous_actions": False}),
    "simple_spread": ("simple_spread", {"continuous_actions": False}),
    **{name: (name, {}) for name in MPEF_WORLDS},
    **{name: (name, {}) for name in HOL_WORLDS},
    **{name: (name, {}) for name in JW_WORLDS},
    "joint_passage_size+pid": ("joint_passage_size", {"use_vel_controller": True}),
    "asym_joint": ("asym_joint", {}),
    "navigation": ("navigation", {}), "flocking": ("flocking", {}), "discovery": ("discovery", {}),
    "discovery,penalty": ("discovery", {"shared_reward": True, "agent_collision_penalty": -1.0,
                                        "targets_respawn": False}),
    "football": ("football", {"ai_red_agents": False}),
    **{name: (name, {}) for name in ("diff_drive", "kinematic_bicycle", "drone", "goal", "vel_control",
                                     "circle_trajectory", "line_trajectory")},
    **{name: (name, {}) for name in ("painting", "construction", "sampling")},
}


def ptxas_table(log):
    """Per instantiation of the fused kernel in nvcc's ``-Xptxas -v``
    output: (form, emit, lanes, registers, stack bytes, spill stores, spill
    loads)."""
    import re

    rows = []
    for part in log.split("Compiling entry function '")[1:]:
        # _Z<n>fused_step_kernel[_thread]ILb<rows>E<n><emit>[Li<lanes>E]E...
        m = re.match(r"_Z\d+fused_step_kernel(_thread)?ILb(\d)E(\d+)", part)
        if not m:
            continue
        emit = part[m.end():m.end() + int(m.group(3))]
        lanes = re.match(r"Li(\d+)E", part[m.end() + len(emit):])
        regs = re.search(r"Used (\d+) registers", part)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", part)
        rows.append(("rows" if m.group(2) == "1" else "fused", emit, int(lanes.group(1)) if lanes else 1,
                     int(regs.group(1)), *(int(v) for v in frame.groups())))
    return rows


def lane_report(dev):
    """Print each instantiation's registers, stack and spills (from the
    build) and, per world, the lanes per env the rule picks and a block's
    shared memory in each form; returns {world: lanes}."""
    import vmas_tpu_torch.core as TC
    from vmas_tpu_torch import _kernels, make_env
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.testing import all_pairs_world

    rows = ptxas_table(_kernels.build_log("fused_step"))
    if sorted({r[2] for r in rows}) != list(F.LANES_BUILT) or len(rows) != FUSED_FORMS * len(F.LANES_BUILT):
        raise AssertionError(f"the build log lists {len(rows)} instantiations of the fused kernel, not "
                             f"{FUSED_FORMS} for each of the lane counts {F.LANES_BUILT}")
    print(f"fused_step build: {len(rows)} instantiations ({FUSED_FORMS} forms at each of the lane counts "
          f"{F.LANES_BUILT})", flush=True)
    for form, emit, lanes, regs, stack, sst, sld in rows:
        print(f"ptxas fused_step_kernel<{form}, {emit}, L={lanes}>: {regs} registers, {stack} B stack, "
              f"spill stores {sst} B, loads {sld} B", flush=True)
    lib = _kernels.library("fused_step")
    picked = {}
    for key, (name, kw) in [*LANE_WORLDS.items(), ("all_pairs", (None, None))]:
        if name is None:
            ks, fo = F._kernel_spec(all_pairs_world(TC, 8, dev)), None
        else:
            env = make_env(name, 8, device=dev, seed=0, fused_physics=True, **kw)
            ks, fo = F._kernel_spec(env.world), env._fused_outputs
        k_in = int(fo.n_scratch_in) if fo is not None else 0
        k_out = int(fo.n_out) if fo is not None else 0
        smem = {"fused": lib.vmas_fused_smem(ks.to_ctypes(k_in), ks.lanes, 0, 0, k_out)}
        if fo is not None and not ks.dyn_gravity and getattr(fo, "carry_extra_idx", None) is not None:
            spec = ks.to_ctypes(k_in, [a.index for a in env.agents] + list(getattr(fo, "script_slots", ())))
            smem["rows"] = lib.vmas_fused_smem(spec, ks.lanes, 1, int(fo.n_ctrl), k_out + int(fo.n_ctrl_out))
        items = {t: len(getattr(ks, t)) for t in F.ITEM_TYPES if getattr(ks, t)}
        print(f"lanes {key}: L = {ks.lanes} (items per type {items}, E {ks.E}); dynamic shared memory per block "
              f"of {128 // ks.lanes} envs: {smem} B", flush=True)
        picked[key] = ks.lanes
    return picked


def entry_lanes(kernels, picked):
    """Each K1/K2 entry of the kernels line gets the lanes per env it ran
    at: its world's, named between the brackets (transport where none)."""
    for e in kernels:
        name = e["name"]
        if name.startswith(("rows_step", "fused_step")):
            world = name[name.index("[") + 1:-1].split(",")[0] if "[" in name else "transport"
            e["lanes"] = picked[world]
    return kernels


def at_lanes(ks, lanes, fn):
    """``fn()`` with the kernel at ``lanes`` lanes per env in place of the
    rule's count for the world of ``ks``."""
    rule, ks.lanes = ks.lanes, lanes
    try:
        return fn()
    finally:
        ks.lanes = rule


def other_form_bitwise(ks, pairs, tag):
    """The form the rule does not pick for the world of ``ks`` against the
    plain version too: the group form (8 lanes) where the rule picks one
    thread per env, else the one-thread form; each (kernel, plain) of
    ``pairs`` bitwise."""
    import torch

    other = 8 if ks.lanes == 1 else 1
    for i, (kern, plain) in enumerate(pairs):
        got, want = at_lanes(ks, other, kern), plain()
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            if not torch.equal(g, w):
                raise AssertionError(f"{tag}: the {other}-lane form differs from the plain version ({i})")
    print(f"{tag}: the {other}-lane form bitwise its plain version too ({len(pairs)} comparisons; the rule picks "
          f"{ks.lanes} lane{'s' if ks.lanes > 1 else ''} per env)", flush=True)


# the plain version's timed calls: up to plain_calls, as many as fit in this
# budget after the first (at least PLAIN_MIN_CALLS): plain versions of the
# stiff worlds take 0.2-1 s a call at 4096 envs
PLAIN_BUDGET_MS = 1000.0
PLAIN_MIN_CALLS = 3


def kernel_times(name, kern, plain, kernel_name, plain_calls=20):
    """Device ms per launch (profiler), wall ms per back-to-back call (CUDA
    events) and the plain version's ms per call (the mean of up to
    ``plain_calls`` calls, fewer where they would pass PLAIN_BUDGET_MS)."""
    dev_ms = launch_ms(kern, 200, kernel_name, name)
    first = time_ms(plain, 1)
    n = min(plain_calls, max(PLAIN_MIN_CALLS, int(PLAIN_BUDGET_MS / first)))
    plain_ms = (first + (n - 1) * time_ms(plain, n - 1, warm=False)) / n if n > 1 else first
    t = {"ms": dev_ms, "wall_ms": time_ms(kern, 500), "plain_ms": plain_ms}
    print(f"{name}: kernel {dev_ms * 1e3:.3f} us on the device, {t['wall_ms'] * 1e3:.3f} us per "
          f"back-to-back call, plain version {t['plain_ms'] * 1e3:.1f} us per call", flush=True)
    return t


# -- balance and the all-pairs world --------------------------------------------

def line_line_tests(ks, rows, fo=None):
    """(line-line tests, of them between crossing segments) that one fused
    step runs on these input rows [9E, B]: those of the ll, bl and bb pairs
    and of balance's emit (the floor's edges against the line), counted by
    running the plain version's pair forces and emit test with its segment
    intersection probed. The device function stops early where the segments
    cross."""
    import torch
    from vmas_tpu_torch.core import fused as F

    E = ks.E
    px, py, rot = list(rows[:E]), list(rows[E:2 * E]), list(rows[4 * E:5 * E])
    hits = []
    real = F._intersection

    def probe(*args):
        out = real(*args)
        hits.append((out[2].numel(), int(out[2].sum())))
        return out

    F._intersection = probe
    try:
        for _ in F._pair_forces(ks, px, py, rot):
            pass
        if fo is not None and hasattr(fo, "floor_i"):
            fi, li = fo.floor_i, fo.line_i
            F._closest_line_box(px[fi], py[fi], torch.cos(rot[fi]), torch.sin(rot[fi]), fo.floor_hw, fo.floor_hl,
                                px[li], py[li], torch.cos(rot[li]), torch.sin(rot[li]), fo.line_half)
    finally:
        F._intersection = real
    return sum(n for n, _ in hits), sum(h for _, h in hits)


# operations read off csrc/fused_step.cu (+, -, *, /, sqrt and a compare
# count 1; cos, sin, exp, log1p and fmod TRIG_OPS): the penalty force 60, a
# closest point on a segment 15, a first-minimum update 8, a box edge 6, an
# inner point 20. Per entity and substep 20, and a cos and a sin for each
# entity whose rotation a pair reads (KernelSpec.trig); per pair, without
# its line-line tests: ss 65; ls 15 + 60 + 12 = 87; ll 60 + 20 = 80; bs 4 x
# 29 + 20 + 60 + 13 = 209; bl 4 x 14 + 20 + 60 + 20 = 156; bb 8 x (14 + 4 x
# 14) + 2 x 20 + 60 + 20 = 680. A line-line test: 43 where the segments
# cross, 43 + 4 x (15 + 8) where they do not.
PAIR_OPS = {"ss": 65, "ls": 87, "ll": 80, "bs": 209, "bl": 156, "bb": 680}
LL_CROSS_OPS, LL_MISS_OPS = 43, 135
# per joint constraint and substep: 4 anchor coordinates 16, the attractive
# and the repulsive penalty 2 x 60, their sum 2, two torques 12, the
# accumulation 8; a rotate=False constraint adds its exponential torque, 31
JOINT_OPS, JOINT_FIXED_OPS = 158, 31


# the in-kernel PID per controlled agent, read off pid_act: the clamp 9,
# the zeroing test 5, the reset test 5, the error 2, the integrator with its
# clip 8, the i term 2, the d term 6, the output 8
PID_OPS = 45


def emit_ops(fo):
    """Operations of a scenario's emit per env, besides writing its rows:
    simple's 2 per landmark and 6 per agent (the squared distance);
    simple_spread's 7 per (agent, landmark) distance and its minimum, 9 per
    ordered pair of agents (the overlap test), 2 per observed offset;
    transport's about 200 per package; balance's 4 trig + 4 x 14 + 116 + 40
    + 20 and its floor-line tests; joint_passage's 2 angle distances (4
    fmod and 10) and the goal's cos and sin, 5 per open passage and 30;
    waterfall's 6 per agent; give_way's 10 per agent (goal distance,
    reached test, shaping, reward) and 2 per other agent observed;
    multi_give_way's 9 per agent and 9 per ordered pair of agents (the
    collision test)."""
    kind = type(fo).__name__
    if kind == "GiveWayOutputs":
        A = fo.n_agents
        return 10 * A + (2 * A * (A - 1) if fo.rel_obs else 0) + 2
    if kind == "MultiGiveWayOutputs":
        A = fo.n_agents
        return 9 * A + 9 * A * (A - 1) + 2
    if kind == "BalanceOutputs":
        return 4 * TRIG_OPS + 56 + 116 + 40 + 20
    if kind == "JointPassageOutputs":
        return 4 * TRIG_OPS + 20 + 2 * TRIG_OPS + 5 * len(fo.open_i) + 30
    if kind == "WaterfallOutputs":
        return 6 * fo.n_agents
    if kind == "SimpleOutputs":
        return fo.n_agents * (2 * len(fo.lm_i) + 6)
    if kind == "SimpleSpreadOutputs":
        A, L = fo.n_agents, len(fo.lm_i)
        return 7 * A * L + L + 2 + 9 * A * (A - 1) + A * (2 * L + 2 * (A - 1) * fo.obs_others)
    if kind in MPEF_EMITS:
        return mpe_family_ops(fo)
    if kind in HOL_EMITS:
        return holonomic_ops(fo)
    if kind in JW_EMITS:
        return joint_worlds_ops(fo)
    if kind in ("NavigationOutputs", "FlockingOutputs", "DiscoveryOutputs"):
        return sensor_ops(fo)
    if kind == "FootballOutputs":
        return football_ops(fo)
    return 200 * fo.n_pkgs


HOL_EMITS = ("ReverseTransportOutputs", "WheelOutputs", "PassageOutputs", "DispersionOutputs", "DropoutOutputs",
             "HetMassOutputs")
# a closest point on a box (4 edges: a closest point on a segment 15, its
# distance 7, a first-minimum update 7) and the overlap test's 3 distances
# and 3 compares
BOX_OVERLAP_OPS = 4 * 29 + 3 * 7 + 3


def holonomic_ops(fo):
    """Operations of the holonomic worlds' emits per env, besides writing
    their rows, read off csrc/fused_step.cu: 7 per distance, 2 per relative
    position, BOX_OVERLAP_OPS and a cos and a sin per box-sphere overlap
    test; reverse_transport's one test and shaping; wheel's line ends, its
    speed terms and fmod; passage's goal distances and shapings, 10 per
    ordered pair of agents (a distance, its test and the penalty term) and
    per (agent, wall) an overlap test and its term; dispersion's 11 per
    (agent, food) reach test and 14 per reward term, 6 per food; dropout's
    13 per agent; het_mass's 8 per agent (a speed and its maximum)."""
    kind = type(fo).__name__
    A = fo.n_agents
    if kind == "ReverseTransportOutputs":
        return 2 * TRIG_OPS + BOX_OVERLAP_OPS + 7 + 4 + 6 * A
    if kind == "WheelOutputs":
        return 3 * TRIG_OPS + 10 + 10 * A
    if kind == "PassageOutputs":
        walls = len(fo.wall_i)
        return (A * (13 + 2 * len(fo.open_i)) + 10 * A * (A - 1)
                + A * walls * (2 * TRIG_OPS + BOX_OVERLAP_OPS + 2))
    if kind == "DispersionOutputs":
        return A * fo.n_food * (11 + 14) + 6 * fo.n_food + 2 * A
    if kind == "DropoutOutputs":
        return 13 * A + 5
    return 8 * A


JW_EMITS = ("BuzzWireOutputs", "BallTrajectoryOutputs", "BallPassageOutputs", "JointPassageSizeOutputs")


def joint_worlds_ops(fo):
    """Operations of the joint worlds' emits per env, besides writing their
    rows, read off csrc/fused_step.cu: 7 per distance, 2 per relative
    position; buzz_wire's cos and sin per line and its line test (a
    closest point on a segment 15, its distance 7, two subtractions, a
    compare, the penalty term 2) per (collidable, line); ball_trajectory's
    closest point on the circle 12, a square root, the speed term 10 and 8
    per agent distance; ball_passage's 8 per open passage, a cos and a sin
    per wall, BOX_OVERLAP_OPS and the term 2 per (collidable, wall), its
    done 9; joint_passage_size's
    middle-angle term (an angle distance: 2 fmod and 10, or two cos and sin
    and 4), done's angle distance, the goal's cos and sin."""
    kind = type(fo).__name__
    A = fo.n_agents
    if kind == "BuzzWireOutputs":
        return 12 + len(fo.lines) * 2 * TRIG_OPS + len(fo.coll) * len(fo.lines) * 27 + 2 * A
    if kind == "BallTrajectoryOutputs":
        return 12 + 7 + 1 + 2 + 10 + 8 * A + 3 + 4 * A
    if kind == "BallPassageOutputs":
        walls = len(fo.wall_i)
        return (8 * len(fo.open_i) + 20 + walls * 2 * TRIG_OPS + len(fo.coll) * walls * (BOX_OVERLAP_OPS + 2) + 9
                + A * (4 + 2 * len(fo.open_i)))
    mid = 2 * TRIG_OPS + 10 if fo.mid_180 else 4 * TRIG_OPS + 4
    return A + 18 + mid + 2 * TRIG_OPS + 14 + 2 * TRIG_OPS + 8 * A + 10


MPEF_EMITS = ("SimplePushOutputs", "SimpleAdversaryOutputs", "SimpleTagOutputs", "SimpleReferenceOutputs",
              "SpeakerListenerOutputs", "SimpleWorldCommOutputs")


def mpe_family_ops(fo):
    """Operations of the other MPE emits per env, besides writing their
    rows: 2 per relative position, 7 per distance, 8 per distance folded
    into a minimum or a sum, 10 per catch or food test and its term, 6 per
    landmark of a goal selection (a compare, a multiply and an add for x
    and y)."""
    kind = type(fo).__name__
    L = len(fo.lm_i)
    if kind == "SpeakerListenerOutputs":
        return 2 * L + 6 * L + 9
    A = fo.n_agents
    if kind == "SimpleReferenceOutputs":
        return A * 2 * L + A * (6 * L + 9)
    goods = sum(1 for adv in fo.adv if not adv)
    advs = A - goods
    rels = 2 * A * (L + A - 1)
    if kind == "SimplePushOutputs":
        return 6 * L + rels + 2 * goods + 8 * goods * advs + 8 * A
    if kind == "SimpleAdversaryOutputs":
        return 6 * L + rels + 2 * goods + 8 * A + 2 * A
    if kind == "SimpleTagOutputs":
        shaped = 8 * advs * goods * (fo.shape_adv + fo.shape_agent)
        return 2 * A * L + sum(2 * len(p) for p, _ in fo.partners) + 2 * 10 * advs * goods + shaped
    # SimpleWorldCommOutputs: the leader's rows, the team catch sum, each
    # good agent's catches, food tests and nearest food
    nf = len(fo.food_i)
    return 2 * A * L + 2 * (A - 1) + 10 * advs * goods + goods * (10 * advs + 10 * nf + 8 * nf + 2)


def kernel_ops(ks, rows, fo=None, rows_form=False):
    """Operations of one fused step on these input rows [R, B] (the line-line
    tests counted on them, once per substep), with the emit's
    (``emit_ops``) and its rows, and in the rows form the in-kernel PID's
    (``PID_OPS`` per controlled agent)."""
    B = rows.shape[1]
    per_substep = (20 * ks.E + 2 * TRIG_OPS * len(ks.trig)
                   + sum(PAIR_OPS[t] * len(getattr(ks, t)) for t in PAIR_OPS)
                   + sum(JOINT_OPS + (0 if r[7] else JOINT_FIXED_OPS) for r in ks.joints))
    per_env = ks.substeps * per_substep
    if fo is not None:
        per_env += emit_ops(fo) + fo.n_out
        if rows_form:
            per_env += PID_OPS * fo.n_ctrl // 4
            if type(getattr(fo, "process_act_rows", None)).__name__ == "BallScriptActRows":
                per_env += BALL_OPS
    n, crossing = line_line_tests(ks, rows[:9 * ks.E], fo)
    return per_env * B + ks.substeps * (crossing * LL_CROSS_OPS + (n - crossing) * LL_MISS_OPS)


def balance_phase(card, dev):
    """balance's two kernel forms against their plain versions from a state
    with contacts, the all-pairs world's fused step against its plain
    version, balance's main path, and the three entries of the kernels
    line."""
    import numpy as np
    import torch
    import vmas_tpu_torch.core as TC
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rows_rollout_fn
    from vmas_tpu_torch.testing import all_pairs_state, all_pairs_world, balance_contact_state

    B = NUM_ENVS
    # -- (a) balance's kernels against plain, at 4096 envs ---------------------
    env = make_env("balance", B, device=dev, seed=0, fused_physics=True)
    world, fo = env.world, env._fused_outputs
    slots = [a.index for a in env.agents]
    ks = F._kernel_spec(world)
    E, A = ks.E, len(slots)
    step = F.make_rows_step(world, fo, slots)
    gen = torch.Generator(device=dev).manual_seed(2)
    acts = lambda: ((torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1) * 0.7).contiguous()
    k2, k1 = ErrTracker(), ErrTracker()
    counts = dict.fromkeys(F.PAIR_TYPES, 0)
    carry = F.pack_carry(world, state_from_numpy(world, balance_contact_state(env, np.random.default_rng(3))), fo)
    for t in range(CMP_STEPS):
        act = acts()
        x = carry.clone()
        x[6 * E + torch.as_tensor(slots, device=dev)] = act[:A]
        x[7 * E + torch.as_tensor(slots, device=dev)] = act[A:]
        for k, v in F.contact_counts(world, x).items():
            counts[k] += v
        c_k, e_k = step(carry, act)
        c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
        compare_rows(k2, c_k[:9 * E], c_p[:9 * E], e_k, e_p, "balance rows_step")
        k2.close("balance rows_step scratch carry", c_k[9 * E:], c_p[9 * E:])
        y_k, y_p = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
        compare_rows(k1, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], "balance fused_step")
        carry = c_k  # re-sync to the kernel
    torch.cuda.synchronize()
    for tr in (k2, k1):
        tr.report()
    print(f"balance contacts over {CMP_STEPS} steps: {counts}", flush=True)
    if any(counts[k] == 0 for k in ("ss", "ls", "bs", "bl")):
        raise AssertionError("the balance comparison saw no contacts of one of its types")
    act = acts()
    x = carry.clone()
    extra = torch.empty((fo.n_out, B), device=dev)
    times = {
        "rows_step[balance]": kernel_times("rows_step[balance]", lambda: step(carry, act, extra),
                                           lambda: F.rows_step_plain(world, fo, slots, carry, act),
                                           "fused_step_kernel"),
        "fused_step[balance]": kernel_times("fused_step[balance]", lambda: F.fused_step(world, x, fo),
                                            lambda: F.fused_step_plain(world, x, fo), "fused_step_kernel"),
    }
    R_in = F.rows_layout(world, fo)
    work = {
        "rows_step[balance]": ((R_in + 2 * A + R_in + fo.n_out) * B * 4, kernel_ops(ks, carry, fo)),
        "fused_step[balance]": ((R_in + 9 * E + fo.n_out) * B * 4, kernel_ops(ks, x, fo)),
    }
    errs = {"rows_step[balance]": k2.max(), "fused_step[balance]": k1.max()}

    # -- (b) the all-pairs world's fused step against plain ----------------------
    aw = all_pairs_world(TC, B, dev)
    aks = F._kernel_spec(aw)
    assert {t: len(getattr(aks, t)) for t in F.PAIR_TYPES} == {"ss": 15, "ls": 12, "ll": 1, "bs": 18, "bl": 6,
                                                                "bb": 3}
    s = state_from_numpy(aw, all_pairs_state(np.random.default_rng(4), B))
    xa = F.state_rows(s).contiguous()
    ka = ErrTracker()
    a_counts = dict.fromkeys(F.PAIR_TYPES, 0)
    x0 = xa
    for t in range(CMP_STEPS):
        for k, v in F.contact_counts(aw, xa).items():
            a_counts[k] += v
        y_k, y_p = F.fused_step(aw, xa), F.fused_step_plain(aw, xa)
        ka.close("all_pairs fused_step state rows", y_k, y_p)
        xa = y_k  # re-sync to the kernel
    torch.cuda.synchronize()
    ka.report()
    print(f"all-pairs contacts over {CMP_STEPS} steps from the packed state: {a_counts}", flush=True)
    if any(v == 0 for v in a_counts.values()):
        raise AssertionError("the all-pairs comparison saw no contacts of one type")
    times["fused_step[all_pairs]"] = kernel_times("fused_step[all_pairs]", lambda: F.fused_step(aw, x0),
                                                  lambda: F.fused_step_plain(aw, x0), "fused_step_kernel")
    work["fused_step[all_pairs]"] = (2 * 9 * aks.E * B * 4, kernel_ops(aks, x0))
    errs["fused_step[all_pairs]"] = ka.max()
    del env, aw, s, xa, x0

    # -- (c) the main path -------------------------------------------------------
    F.fused_step_launches = 0
    F.rows_step_launches = 0
    env = make_env("balance", num_envs=B, fused_physics=True)  # 3 agents, every other default
    assert env.device.type == "cuda" and env.n_agents == 3
    obs = env.reset()
    for _ in range(5):
        obs, rews, dones, infos = env.step(env.get_random_actions())
    assert all(o.shape == (B, 16) and bool(torch.isfinite(o).all()) for o in obs)
    assert all(r.shape == (B,) and bool(torch.isfinite(r).all()) for r in rews)
    assert dones.shape == (B,) and len(infos) == 3
    run = rows_rollout_fn(env, horizon=HORIZON)
    rgen = torch.Generator(device=dev).manual_seed(0)
    state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
    launches = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
    assert traj["rewards"].shape == (HORIZON, B, 3) and traj["dones"].shape == (HORIZON, B)
    assert len(traj["obs"]) == 3 and all(o.shape == (HORIZON, B, 16) for o in traj["obs"])
    assert bool(torch.isfinite(traj["rewards"]).all()) and all(bool(torch.isfinite(o).all()) for o in traj["obs"])
    assert bool(torch.isfinite(state.pos).all())
    assert int(steps[0]) == 5 + HORIZON * (1 + TIMED_CALLS)
    assert launches == {"fused_step": 5, "rows_step": HORIZON * (1 + TIMED_CALLS)}, launches
    print(f"main path: rows_rollout_fn balance {B} envs x 3 agents x {HORIZON} steps: "
          f"calls {[round(c, 3) for c in call_ms]} ms (warm-up {warm_s:.3f} s), "
          f"best {B * HORIZON / (min(call_ms) / 1e3):.1f} env-steps/s, "
          f"mean {B * HORIZON * TIMED_CALLS / (sum(call_ms) / 1e3):.1f} env-steps/s on {card}; "
          f"launches {launches}; episodes ended in the last call "
          f"{int(traj['dones'].sum())} of {HORIZON * B} env-steps", flush=True)
    _, busy_ms, by_name, _, _ = device_ms(lambda: run(state, steps, rgen), 1, "")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"device time of one balance rows_rollout_fn call: {busy_ms:.3f} ms busy of {min(call_ms):.3f} ms wall "
          f"(idle share {1 - busy_ms / min(call_ms):.3f}); top: "
          + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top), flush=True)

    # -- (d) the kernels line ----------------------------------------------------
    # one kernel serves every world: "launches" counts its wrapper's launches
    # on balance's main path, also for the all-pairs world's entry
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    entries = [
        kernel_entry(name, src, site, launches[form], errs[name], times[name], *work[name])
        for name, form, site in (
            ("rows_step[balance]", "rows_step", "vmas_tpu/core/fused.py:1603"),
            ("fused_step[balance]", "fused_step", "vmas_tpu/core/fused.py:1425"),
            ("fused_step[all_pairs]", "fused_step", "vmas_tpu/core/fused.py:1425"),
        )
    ]
    entries[-1]["launches_on"] = "balance's main path"
    return entries


# -- joints: joint_passage and waterfall --------------------------------------

def with_actions(carry, act, slots, E):
    """The carry with this step's actions in the agents' force rows, as
    env.step packs the fused step's input."""
    import torch

    x = carry.clone()
    idx = torch.as_tensor(slots, device=carry.device)
    x[6 * E + idx] = act[:len(slots)]
    x[7 * E + idx] = act[len(slots):]
    return x


def joints_phase(card, dev):
    """joint_passage's two kernel forms against their plain versions from a
    state with contacts and its joints pulled apart, waterfall's from a
    pile, joint_passage's main path, and the three entries of the kernels
    line."""
    import numpy as np
    import torch
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn
    from vmas_tpu_torch.testing import joint_passage_contact_state, waterfall_contact_state

    B = NUM_ENVS
    # -- (a) joint_passage's kernels against plain, at 4096 envs ---------------
    env = make_env("joint_passage", B, device=dev, seed=0, fused_physics=True)
    world, fo = env.world, env._fused_outputs
    slots = [a.index for a in env.agents]
    ks = F._kernel_spec(world)
    E, A = ks.E, len(slots)
    assert (ks.J, len(ks.ss), len(ks.ls), len(ks.bs), len(ks.bl), ks.substeps) == (3, 1, 12, 39, 2, 10)
    step = F.make_rows_step(world, fo, slots)
    gen = torch.Generator(device=dev).manual_seed(5)
    acts = lambda: ((torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1) * 0.8).contiguous()
    k2, k1 = ErrTracker(), ErrTracker()
    counts = dict.fromkeys(F.PAIR_TYPES, 0)
    joint_lanes = 0
    carry = F.pack_carry(world, state_from_numpy(world, joint_passage_contact_state(env, np.random.default_rng(6))),
                         fo)
    for t in range(JP_CMP_STEPS):
        act = acts()
        x = with_actions(carry, act, slots, E)
        for k, v in F.contact_counts(world, x).items():
            counts[k] += v
        joint_lanes += F.joint_counts(world, x)["force"]
        c_k, e_k = step(carry, act)
        c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
        compare_rows(k2, c_k[:9 * E], c_p[:9 * E], e_k, e_p, "joint_passage rows_step")
        k2.close("joint_passage rows_step carried rows", c_k[9 * E:], c_p[9 * E:])
        y_k, y_p = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
        compare_rows(k1, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], "joint_passage fused_step")
        carry = c_k  # re-sync to the kernel
    torch.cuda.synchronize()
    for tr in (k2, k1):
        tr.report()
    print(f"joint_passage contacts over {JP_CMP_STEPS} steps: {counts}; (constraint, env) lanes with a joint force: "
          f"{joint_lanes} of {JP_CMP_STEPS * ks.J * B}", flush=True)
    if any(counts[k] == 0 for k in ("ss", "ls", "bs", "bl")) or joint_lanes == 0:
        raise AssertionError("the joint_passage comparison saw no contacts of one of its types or no joint force")

    # env.step's path (K1) against the rows path (K2): one device function
    s0, st0 = env.state, env.steps
    _, _, ta = rollout_fn(env, horizon=JP_CMP_STEPS)(s0, st0, torch.Generator(device=dev).manual_seed(7))
    _, _, tb = rows_rollout_fn(env, horizon=JP_CMP_STEPS)(s0, st0, torch.Generator(device=dev).manual_seed(7))
    same = torch.equal(ta["rewards"], tb["rewards"]) and all(torch.equal(a, b) for a, b in zip(ta["obs"], tb["obs"]))
    rollout_err = max(float((a - b).abs().max()) for a, b in zip(ta["obs"], tb["obs"]))
    print(f"joint_passage env.step rollout vs rows rollout over {JP_CMP_STEPS} steps: bitwise equal {same}, "
          f"max abs obs err {rollout_err:.3e}", flush=True)
    if not same or not torch.equal(ta["dones"], tb["dones"]):
        raise AssertionError("joint_passage env.step rollout and rows rollout differ")

    act = acts()
    x = with_actions(carry, act, slots, E)
    extra = torch.empty((fo.n_out, B), device=dev)
    times = {
        "rows_step[joint_passage]": kernel_times(
            "rows_step[joint_passage]", lambda: step(carry, act, extra),
            lambda: F.rows_step_plain(world, fo, slots, carry, act), "fused_step_kernel"),
        "fused_step[joint_passage]": kernel_times(
            "fused_step[joint_passage]", lambda: F.fused_step(world, x, fo),
            lambda: F.fused_step_plain(world, x, fo), "fused_step_kernel"),
    }
    R_in = F.rows_layout(world, fo)
    work = {
        "rows_step[joint_passage]": ((R_in + 2 * A + R_in + fo.n_out) * B * 4, kernel_ops(ks, carry, fo)),
        "fused_step[joint_passage]": ((R_in + 9 * E + fo.n_out) * B * 4, kernel_ops(ks, x, fo)),
    }
    errs = {"rows_step[joint_passage]": k2.max(), "fused_step[joint_passage]": k1.max()}
    one = at_lanes(ks, 1, lambda: launch_ms(lambda: step(carry, act, extra), 200, "fused_step_kernel",
                                            "the other form"))
    print(f"rows_step[joint_passage] in the same run: {times['rows_step[joint_passage]']['ms'] * 1e3:.3f} us at "
          f"L = {ks.lanes} (the rule's), {one * 1e3:.3f} us in the one-thread form (L = 1)", flush=True)
    del env, carry, x, s0

    # -- (b) waterfall's kernels against plain ----------------------------------
    wenv = make_env("waterfall", B, device=dev, seed=0, fused_physics=True)
    ww, wfo = wenv.world, wenv._fused_outputs
    wslots = [a.index for a in wenv.agents]
    wks = F._kernel_spec(ww)
    WE, WA = wks.E, len(wslots)
    assert {t: len(getattr(wks, t)) for t in F.PAIR_TYPES} == {"ss": 10, "ls": 21, "ll": 15, "bs": 30, "bl": 35,
                                                                "bb": 15} and wks.J == 10
    wstep = F.make_rows_step(ww, wfo, wslots)
    kw = ErrTracker()
    w_counts = dict.fromkeys(F.PAIR_TYPES, 0)
    torque_lanes = 0
    wcarry = F.pack_carry(ww, state_from_numpy(ww, waterfall_contact_state(wenv, np.random.default_rng(8))), wfo)
    for t in range(WF_CMP_STEPS):
        act = ((torch.rand((2 * WA, B), generator=gen, device=dev) * 2 - 1) * 0.7).contiguous()
        x = with_actions(wcarry, act, wslots, WE)
        for k, v in F.contact_counts(ww, x).items():
            w_counts[k] += v
        torque_lanes += F.joint_counts(ww, x)["torque"]
        c_k, e_k = wstep(wcarry, act)
        c_p, e_p = F.rows_step_plain(ww, wfo, wslots, wcarry, act)
        y_k, y_p = F.fused_step(ww, x, wfo), F.fused_step_plain(ww, x, wfo)
        kw.close("waterfall rows_step carried rows (state, fixed rotations)", c_k, c_p)
        kw.close("waterfall fused_step state rows", y_k[:9 * WE], y_p[:9 * WE])
        for tag, ek, ep in (("rows_step", e_k, e_p), ("fused_step", y_k[9 * WE:], y_p[9 * WE:])):
            kw.close(f"waterfall {tag} obs rows", ek[:wfo.base], ep[:wfo.base])
            kw.close(f"waterfall {tag} reward rows", ek[wfo.base:], ep[wfo.base:])
        wcarry = c_k  # re-sync to the kernel
    torch.cuda.synchronize()
    kw.report()
    print(f"waterfall contacts over {WF_CMP_STEPS} steps from its contact state: {w_counts}; (constraint, env) lanes with "
          f"the fixed-rotation torque active (|delta| >= 1e-9): {torque_lanes}", flush=True)
    if any(v == 0 for v in w_counts.values()) or torque_lanes == 0:
        raise AssertionError("the waterfall comparison saw no contacts of one type or no fixed-rotation torque")
    xw = with_actions(wcarry, act, wslots, WE)
    times["fused_step[waterfall]"] = kernel_times(
        "fused_step[waterfall]", lambda: F.fused_step(ww, xw, wfo), lambda: F.fused_step_plain(ww, xw, wfo),
        "fused_step_kernel", plain_calls=WF_PLAIN_CALLS)
    work["fused_step[waterfall]"] = ((F.rows_layout(ww, wfo) + 9 * WE + wfo.n_out) * B * 4, kernel_ops(wks, xw, wfo))
    errs["fused_step[waterfall]"] = kw.max()
    del wenv, wcarry, x, xw

    # -- (c) the main path -------------------------------------------------------
    F.fused_step_launches = 0
    F.rows_step_launches = 0
    env = make_env("joint_passage", num_envs=B, fused_physics=True)  # every default
    assert env.device.type == "cuda" and env.n_agents == 2
    obs = env.reset()
    for _ in range(5):
        obs, rews, dones, infos = env.step(env.get_random_actions())
    assert all(o.shape == (B, 10) and bool(torch.isfinite(o).all()) for o in obs)
    assert all(r.shape == (B,) and bool(torch.isfinite(r).all()) for r in rews)
    assert dones.shape == (B,) and len(infos) == 2
    run = rows_rollout_fn(env, horizon=HORIZON)
    rgen = torch.Generator(device=dev).manual_seed(0)
    state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
    launches = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
    assert traj["rewards"].shape == (HORIZON, B, 2) and traj["dones"].shape == (HORIZON, B)
    assert len(traj["obs"]) == 2 and all(o.shape == (HORIZON, B, 10) for o in traj["obs"])
    assert bool(torch.isfinite(traj["rewards"]).all()) and all(bool(torch.isfinite(o).all()) for o in traj["obs"])
    assert bool(torch.isfinite(state.pos).all())
    assert int(steps[0]) == 5 + HORIZON * (1 + TIMED_CALLS)
    assert launches == {"fused_step": 5, "rows_step": HORIZON * (1 + TIMED_CALLS)}, launches
    print(f"main path: rows_rollout_fn joint_passage {B} envs x 2 agents x {HORIZON} steps: "
          f"calls {[round(c, 3) for c in call_ms]} ms (warm-up {warm_s:.3f} s), "
          f"best {B * HORIZON / (min(call_ms) / 1e3):.1f} env-steps/s, "
          f"mean {B * HORIZON * TIMED_CALLS / (sum(call_ms) / 1e3):.1f} env-steps/s on {card}; "
          f"launches {launches}; episodes ended in the last call {int(traj['dones'].sum())} of {HORIZON * B} "
          f"env-steps", flush=True)
    _, busy_ms, by_name, _, _ = device_ms(lambda: run(state, steps, rgen), 1, "")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"device time of one joint_passage rows_rollout_fn call: {busy_ms:.3f} ms busy of {min(call_ms):.3f} ms "
          f"wall (idle share {1 - busy_ms / min(call_ms):.3f}); top: "
          + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top), flush=True)

    # -- (d) the kernels line ----------------------------------------------------
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    entries = [
        kernel_entry(name, src, site, launches[form], errs[name], times[name], *work[name])
        for name, form, site in (
            ("rows_step[joint_passage]", "rows_step", "vmas_tpu/core/fused.py:1603"),
            ("fused_step[joint_passage]", "fused_step", "vmas_tpu/core/fused.py:1425"),
            ("fused_step[waterfall]", "fused_step", "vmas_tpu/core/fused.py:1425"),
        )
    ]
    entries[-1]["launches_on"] = "joint_passage's main path"
    return entries


# -- give_way: the in-kernel PID velocity controller and k_steps ----------------

def compare_pid_carry(tr, fo, R, E, c_k, c_p, e_k, e_p, tag):
    """Kernel against plain for the rows step's carry (state, scratch and
    controller rows) and its hook rows (the controller's output), bitwise."""
    n_ctrl, n_out = fo.n_ctrl, fo.n_out
    tr.close(f"{tag} state rows", c_k[:9 * E], c_p[:9 * E])
    tr.close(f"{tag} scratch rows", c_k[9 * E:R - n_ctrl], c_p[9 * E:R - n_ctrl])
    tr.close(f"{tag} controller rows", c_k[R - n_ctrl:], c_p[R - n_ctrl:])
    tr.close(f"{tag} hook rows (controller output)", e_k[n_out:], e_p[n_out:])


def pid_act_rows(env, rng, dev):
    """testing.pid_actions as the rows step's [2A, B] action rows on ``dev``."""
    import numpy as np
    import torch
    from vmas_tpu_torch.testing import pid_actions

    acts = pid_actions(env, rng)
    rows = np.concatenate([np.stack([a[:, 0] for a in acts]), np.stack([a[:, 1] for a in acts])])
    return torch.as_tensor(rows, device=dev).contiguous()


def timed_rollout(run, state, steps, rgen, calls=TIMED_CALLS):
    """One warm-up call and ``calls`` timed calls (CUDA events): (state,
    steps, last traj, ms per timed call, warm-up seconds)."""
    import torch

    t0 = time.perf_counter()
    state, steps, traj = run(state, steps, rgen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    call_ms = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, steps, traj = run(state, steps, rgen)
        end.record()
        end.synchronize()
        call_ms.append(start.elapsed_time(end))
    return state, steps, traj, call_ms, warm_s


def rollout_report(tag, run, state, steps, rgen, call_ms, warm_s, B, card, horizon=HORIZON, trace=None):
    """Prints a timed rollout's env-steps/s and the device idle share of one
    more call (profiler); returns (best env-steps/s, idle share). With
    ``trace=(run', steps')`` the profiler traces a call of ``run'``, a
    rollout of ``steps'`` steps, against its own wall time (CUDA events):
    the profiler costs the host some 0.45 ms a device operation, so a host-
    bound loop of a few hundred operations a step is traced over fewer
    steps than it is timed."""
    best = B * horizon / (min(call_ms) / 1e3)
    mean = B * horizon * len(call_ms) / (sum(call_ms) / 1e3)
    t_run, t_steps = trace if trace is not None else (run, horizon)
    wall_ms = min(call_ms) if trace is None else time_ms(lambda: t_run(state, steps, rgen), 2)
    _, busy_ms, by_name, n_ops, _ = device_ms(lambda: t_run(state, steps, rgen), 1, "")
    idle = 1 - busy_ms / wall_ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    print(f"{tag}: calls {[round(c, 3) for c in call_ms]} ms (warm-up {warm_s:.3f} s), best {best:.1f} env-steps/s, "
          f"mean {mean:.1f} env-steps/s on {card}; device {busy_ms:.3f} ms busy of {wall_ms:.3f} ms "
          + (f"in a traced call of {t_steps} steps " if trace is not None else "")
          + f"(idle share {idle:.3f}, {n_ops / t_steps:.1f} device operations a step); top: "
          + "; ".join(f"{k[:50]} {v:.3f} ms" for k, v in top), flush=True)
    return best, idle


def k_steps_check(world, fo, slots, carry, act, tag, compare):
    """One launch of K_STEPS env steps (action rows ``act``, [K_STEPS * 2A,
    B]) against K_STEPS launches of one, carry and output rows bitwise, and
    against the plain version's K_STEPS steps: ``compare(tr, k, c_k, c_p,
    e_k, e_p, mid)`` holds step k's output block (and the carry after the
    last step) to it, ``mid`` being the carry after step k. Raises on a
    difference; returns the tracker of the plain comparison."""
    import torch
    from vmas_tpu_torch.core import fused as F

    A2 = 2 * len(slots)
    c4, e4 = F.make_rows_step(world, fo, slots, k_steps=K_STEPS)(carry, act)
    one = F.make_rows_step(world, fo, slots)
    c1, blocks, mids = carry, [], []
    for k in range(K_STEPS):
        c1, e1 = one(c1, act[k * A2:(k + 1) * A2].contiguous())
        blocks.append(e1)
        mids.append(c1)
    torch.cuda.synchronize()
    e1 = torch.cat(blocks)
    same = torch.equal(c4, c1) and torch.equal(e4, e1)
    err = max(float((c4 - c1).abs().max()), float((e4 - e1).abs().max()))
    print(f"{tag}: one launch of {K_STEPS} steps vs {K_STEPS} launches of one: bitwise equal {same} "
          f"(max abs err {err:.3e})", flush=True)
    if not same:
        raise AssertionError(f"{tag}: k_steps={K_STEPS} does not replay k_steps=1")
    c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act, K_STEPS)
    n_tot = fo.n_out + fo.n_ctrl_out
    tr = ErrTracker()
    for k in range(K_STEPS):
        blk = slice(k * n_tot, (k + 1) * n_tot)
        compare(tr, k, c4, c_p, e4[blk], e_p[blk], mids[k])
    tr.report()
    return tr


def give_way_phase(card, dev):
    """give_way's and multi_give_way's kernel forms against their plain
    versions with the in-kernel PID, joint_passage's controller config,
    k_steps against single steps, give_way's two rollouts, give_way's main
    path at k_steps 1 and 4, transport's rows rollout at both, and the five
    entries of the kernels line."""
    import numpy as np
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn

    B = NUM_ENVS
    times, work, errs = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(21)

    # -- (a) K2 with the PID, and K1, against plain -----------------------------
    for k, name in enumerate(("give_way", "multi_give_way")):
        env = make_env(name, B, device=dev, seed=0, fused_physics=True)
        world, fo = env.world, env._fused_outputs
        slots = [a.index for a in env.agents]
        ks = F._kernel_spec(world)
        E, A, R = ks.E, len(slots), F.rows_layout(world, fo)
        step = F.make_rows_step(world, fo, slots)
        k2, k1 = ErrTracker(), ErrTracker()
        counts = dict.fromkeys(F.PAIR_TYPES, 0)
        pid = {"reset": 0, "clamp": 0, "min_input": 0, "cutoff": 0}
        build = getattr(testing, f"{name}_contact_state")
        carry = F.pack_carry(world, state_from_numpy(world, build(env, np.random.default_rng(20 + k))), fo)
        rng = np.random.default_rng(30 + k)
        for t in range(GW_CMP_STEPS):
            act = pid_act_rows(env, rng, dev)
            x = with_actions(carry[:R - fo.n_ctrl], act, slots, E)
            for kk, v in F.contact_counts(world, x).items():
                counts[kk] += v
            for kk, v in testing.pid_counts(world, fo, carry, act).items():
                pid[kk] += v
            c_k, e_k = step(carry, act)
            c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
            compare_pid_carry(k2, fo, R, E, c_k, c_p, e_k, e_p, f"{name} rows_step")
            compare_rows(k2, None, None, e_k[:fo.n_out], e_p[:fo.n_out], f"{name} rows_step")
            y_k, y_p = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
            compare_rows(k1, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], f"{name} fused_step")
            carry = c_k  # re-sync to the kernel
        torch.cuda.synchronize()
        for tr in (k2, k1):
            tr.report()
        print(f"{name} over {GW_CMP_STEPS} steps: contacts {counts}; (agent, env) lanes in which the PID's memory "
              f"reset, the u_range clamp, the min_input_norm zeroing and the integrator cutoff acted: {pid}",
              flush=True)
        if counts["ss"] == 0 or counts["ls"] == 0 or not all(pid.values()):
            raise AssertionError(f"the {name} comparison missed a contact type or a branch of the PID")
        act = pid_act_rows(env, rng, dev)
        x = with_actions(carry[:R - fo.n_ctrl], act, slots, E)
        n_tot = fo.n_out + fo.n_ctrl_out
        extra = torch.empty((n_tot, B), device=dev)
        key = f"rows_step[{name}]"
        times[key] = kernel_times(key, lambda: step(carry, act, extra),
                                  lambda: F.rows_step_plain(world, fo, slots, carry, act), "fused_step_kernel")
        work[key] = ((R + 2 * A + R + n_tot) * B * 4, kernel_ops(ks, carry, fo, rows_form=True))
        errs[key] = k2.max()
        if name == "give_way":
            times["fused_step[give_way]"] = kernel_times(
                "fused_step[give_way]", lambda: F.fused_step(world, x, fo),
                lambda: F.fused_step_plain(world, x, fo), "fused_step_kernel")
            work["fused_step[give_way]"] = ((R - fo.n_ctrl + 9 * E + fo.n_out) * B * 4, kernel_ops(ks, x, fo))
            errs["fused_step[give_way]"] = k1.max()
            # -- (c) k_steps at give_way, then its K-step kernel's times
            key = f"rows_step[give_way,k{K_STEPS}]"
            act_k = torch.cat([pid_act_rows(env, rng, dev) for _ in range(K_STEPS)]).contiguous()

            def gw_compare(tr, k, c_k, c_p, e_k, e_p, mid, tag=key):
                compare_pid_carry(tr, fo, R, E, c_k, c_p, e_k, e_p, tag)
                compare_rows(tr, None, None, e_k[:fo.n_out], e_p[:fo.n_out], tag)

            errs[key] = k_steps_check(world, fo, slots, carry, act_k, "give_way", gw_compare).max()
            step_k = F.make_rows_step(world, fo, slots, k_steps=K_STEPS)
            extra_k = torch.empty((K_STEPS * n_tot, B), device=dev)
            times[key] = kernel_times(key, lambda: step_k(carry, act_k, extra_k),
                                      lambda: F.rows_step_plain(world, fo, slots, carry, act_k, K_STEPS),
                                      "fused_step_kernel")
            work[key] = ((R + K_STEPS * 2 * A + R + K_STEPS * n_tot) * B * 4,
                         K_STEPS * kernel_ops(ks, carry, fo, rows_form=True))

            # -- (d) env.step's rollout (the PID in PyTorch, then K1) against
            # the rows rollout (the PID in K2)
            s0, st0 = env.state, env.steps
            sa, _, ta = rollout_fn(env, horizon=GW_CMP_STEPS)(s0, st0, torch.Generator(device=dev).manual_seed(7))
            sb, _, tb = rows_rollout_fn(env, horizon=GW_CMP_STEPS)(s0, st0,
                                                                   torch.Generator(device=dev).manual_seed(7))
            mem = [(sa.scenario[kk][m], sb.scenario[kk][m])
                   for kk in sa.scenario if kk.startswith("__vel_ctrl") for m in ("accum_errs", "prev_err")]
            pairs = {"rewards": [(ta["rewards"], tb["rewards"])], "dones": [(ta["dones"], tb["dones"])],
                     "obs": list(zip(ta["obs"], tb["obs"])), "final pos": [(sa.pos, sb.pos)],
                     "final vel": [(sa.vel, sb.vel)], "final u": list(zip(sa.u, sb.u)), "controller memory": mem}
            assert len(mem) == 2 * env.n_agents
            differ = [name for name, ps in pairs.items() if not all(torch.equal(a, b) for a, b in ps)]
            errs_d = {name: max(float((a.float() - b.float()).abs().max()) for a, b in ps)
                      for name, ps in pairs.items()}
            print(f"give_way env.step rollout vs rows rollout over {GW_CMP_STEPS} steps: bitwise equal "
                  f"{not differ}; max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs_d.items()), flush=True)
            if differ:
                raise AssertionError(f"give_way env.step rollout and rows rollout differ in {differ}")
        del env, carry, x

    # -- (b) joint_passage with its controller: K2 against plain ------------------
    env = make_env("joint_passage", B, device=dev, seed=0, fused_physics=True, use_controller=True)
    world, fo = env.world, env._fused_outputs
    slots = [a.index for a in env.agents]
    ks = F._kernel_spec(world)
    E, A, R = ks.E, len(slots), F.rows_layout(world, fo)
    step = F.make_rows_step(world, fo, slots)
    kj = ErrTracker()
    pid = {"reset": 0, "clamp": 0, "min_input": 0, "cutoff": 0}
    carry = F.pack_carry(world, state_from_numpy(world, testing.joint_passage_contact_state(
        env, np.random.default_rng(22))), fo)
    rng = np.random.default_rng(32)
    for t in range(JPC_CMP_STEPS):
        act = pid_act_rows(env, rng, dev)
        for kk, v in testing.pid_counts(world, fo, carry, act).items():
            pid[kk] += v
        c_k, e_k = step(carry, act)
        c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
        compare_pid_carry(kj, fo, R, E, c_k, c_p, e_k, e_p, "joint_passage+pid rows_step")
        compare_rows(kj, None, None, e_k[:fo.n_out], e_p[:fo.n_out], "joint_passage+pid rows_step")
        carry = c_k
    torch.cuda.synchronize()
    kj.report()
    print(f"joint_passage+pid over {JPC_CMP_STEPS} steps: lanes in which the PID acted {pid}", flush=True)
    if pid["reset"] == 0:
        raise AssertionError("the joint_passage+pid comparison missed the PID's memory reset")
    act = pid_act_rows(env, rng, dev)
    extra = torch.empty((fo.n_out + fo.n_ctrl_out, B), device=dev)
    key = "rows_step[joint_passage+pid]"
    times[key] = kernel_times(key, lambda: step(carry, act, extra),
                              lambda: F.rows_step_plain(world, fo, slots, carry, act), "fused_step_kernel",
                              plain_calls=WF_PLAIN_CALLS)
    work[key] = ((R + 2 * A + R + fo.n_out + fo.n_ctrl_out) * B * 4, kernel_ops(ks, carry, fo, rows_form=True))
    errs[key] = kj.max()
    del env, carry

    # -- (c) k_steps at transport ---------------------------------------------------
    tenv = make_env("transport", B, device=dev, n_agents=N_AGENTS, seed=0, fused_physics=True)
    tfo, tE = tenv._fused_outputs, len(tenv.world.entities)

    def tp_compare(tr, k, c_k, c_p, e_k, e_p, mid, tag=f"transport rows_step k{K_STEPS}"):
        # each step's emit rows; the carry after the last step
        last = k == K_STEPS - 1
        compare_rows(tr, c_k[:9 * tE] if last else None, c_p[:9 * tE], e_k, e_p, tag)
        if last:
            tr.close(f"{tag} scratch carry", c_k[9 * tE:], c_p[9 * tE:])

    tact = ((torch.rand((K_STEPS * 2 * N_AGENTS, B), generator=gen, device=dev) * 2 - 1) * 0.6).contiguous()
    tcarry = F.pack_carry(tenv.world, contact_rich(tenv, gen), tfo)
    k_steps_check(tenv.world, tfo, [a.index for a in tenv.agents], tcarry, tact, "transport", tp_compare)

    # -- (e) the main path at k_steps 1, then 4 ------------------------------------
    F.fused_step_launches = 0
    F.rows_step_launches = 0
    env = make_env("give_way", num_envs=B, fused_physics=True)  # every default: 2 agents, the PID on
    assert env.device.type == "cuda" and env.n_agents == 2 and env._fused_outputs.n_ctrl == 8
    obs = env.reset()
    for _ in range(5):
        obs, rews, dones, infos = env.step(env.get_random_actions())
    assert all(o.shape == (B, 4) and bool(torch.isfinite(o).all()) for o in obs)
    assert all(r.shape == (B,) and bool(torch.isfinite(r).all()) for r in rews)
    assert dones.shape == (B,) and len(infos) == 2
    rgen = torch.Generator(device=dev).manual_seed(0)
    run = rows_rollout_fn(env, horizon=HORIZON)
    state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
    launches = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
    assert launches == {"fused_step": 5, "rows_step": HORIZON * (1 + TIMED_CALLS)}, launches
    F.fused_step_launches = 0
    F.rows_step_launches = 0
    run_k = rows_rollout_fn(env, horizon=HORIZON, k_steps=K_STEPS)
    state, steps, traj_k, call_k_ms, warm_k_s = timed_rollout(run_k, state, steps, rgen)
    launches_k = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
    assert launches_k == {"fused_step": 0, "rows_step": HORIZON * (1 + TIMED_CALLS) // K_STEPS}, launches_k
    for tr in (traj, traj_k):
        assert tr["rewards"].shape == (HORIZON, B, 2) and tr["dones"].shape == (HORIZON, B)
        assert all(o.shape == (HORIZON, B, 4) and bool(torch.isfinite(o).all()) for o in tr["obs"])
        assert bool(torch.isfinite(tr["rewards"]).all())
    assert bool(torch.isfinite(state.pos).all()) and all(bool(torch.isfinite(u).all()) for u in state.u)
    assert int(steps[0]) == 5 + 2 * HORIZON * (1 + TIMED_CALLS)
    print(f"main path: give_way {B} envs x 2 agents x {HORIZON} steps; launches {launches} at k_steps 1, "
          f"{launches_k} at k_steps {K_STEPS}; episodes ended in the last calls {int(traj['dones'].sum())} and "
          f"{int(traj_k['dones'].sum())} of {HORIZON * B} env-steps", flush=True)
    rollout_report("give_way rows_rollout_fn k_steps 1", run, state, steps, rgen, call_ms, warm_s, B, card)
    rollout_report(f"give_way rows_rollout_fn k_steps {K_STEPS}", run_k, state, steps, rgen, call_k_ms, warm_k_s,
                   B, card)
    del env, state, traj, traj_k

    # transport's rows rollout at k_steps 1 and 4, side by side
    for kk in (1, K_STEPS):
        trun = rows_rollout_fn(tenv, horizon=HORIZON, k_steps=kk)
        ts, tst, _, t_ms, t_warm = timed_rollout(trun, tenv.state, tenv.steps, rgen)
        rollout_report(f"transport rows_rollout_fn k_steps {kk}", trun, ts, tst, rgen, t_ms, t_warm, B, card)
    del tenv

    # -- (f) the kernels line ---------------------------------------------------------
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    entries = [
        kernel_entry(name, src, site, n, errs[name], times[name], *work[name])
        for name, site, n in (
            ("rows_step[give_way]", "vmas_tpu/core/fused.py:1603", launches["rows_step"]),
            ("fused_step[give_way]", "vmas_tpu/core/fused.py:1425", launches["fused_step"]),
            ("rows_step[multi_give_way]", "vmas_tpu/core/fused.py:1603", launches["rows_step"]),
            ("rows_step[joint_passage+pid]", "vmas_tpu/core/fused.py:1603", launches["rows_step"]),
            (f"rows_step[give_way,k{K_STEPS}]", "vmas_tpu/core/fused.py:1603", launches_k["rows_step"]),
        )
    ]
    for e in entries[2:4]:
        e["launches_on"] = "give_way's main path at k_steps 1"
    entries[4]["launches_on"] = f"give_way's main path at k_steps {K_STEPS}"
    return entries


# -- wind_flocking: dynamic gravity in the fused step ---------------------------

# operations per movable entity and substep of the dynamic-gravity term (two
# additions, two multiplications)
DYN_G_OPS = 4


def wind_flocking_phase(card, dev):
    """wind_flocking's fused step (K1 with the dynamic-gravity rows) against
    its plain version along env.step, bitwise, with the lanes of a weakened
    wind; its main path (rollout_fn); its entry of the kernels line."""
    import numpy as np
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rollout_fn

    B = NUM_ENVS
    env = make_env("wind_flocking", B, device=dev, seed=0, fused_physics=True)
    world, sc = env.world, env.scenario
    ks = F._kernel_spec(world)
    E = ks.E
    assert ks.dyn_gravity and env._fused_outputs is None
    env.state = state_from_numpy(world, testing.wind_flocking_state(env, np.random.default_rng(50)))
    # -- (a) K1 against plain on the rows env.step hands it, re-synced to
    # the kernel by env.step itself
    seen = []
    kernel = F.fused_step

    def capture(w, x, outputs=None):
        y = kernel(w, x, outputs)
        seen.append((x.clone(), y))
        return y

    F.fused_step = capture
    differ, weak, contacts = 0, 0, 0
    try:
        for t in range(WFL_CMP_STEPS):
            env.step(env.get_random_actions())
            x, y = seen[-1]
            contacts += F.contact_counts(world, x)["ss"]
            differ += int((y != F.fused_step_plain(world, x)).any(0).sum())
            big = env.state.dyn_gravity[:, sc.big_agent.index].norm(dim=-1)
            weak += int(((big > 0) & (big < float(sc.wind_vec.norm()))).sum())
    finally:
        F.fused_step = kernel
    torch.cuda.synchronize()
    assert len(seen) == WFL_CMP_STEPS and seen[0][0].shape == (9 * E + 2 * E, B)
    print(f"wind_flocking fused_step (dynamic gravity) vs plain over {WFL_CMP_STEPS} env.step calls: envs that "
          f"differ {differ}; (step, env) lanes with the big agent's wind weakened (strictly between 0 and full) "
          f"{weak}; sphere-sphere contacts {contacts}", flush=True)
    if differ or weak == 0:
        raise AssertionError("wind_flocking's fused step differs from its plain version, or no wind was weakened")
    x = seen[-1][0]
    other_form_bitwise(ks, [(lambda: F.fused_step(world, x), lambda: F.fused_step_plain(world, x))], "wind_flocking")
    key = "fused_step[wind_flocking]"
    times = kernel_times(key, lambda: F.fused_step(world, x), lambda: F.fused_step_plain(world, x),
                         "fused_step_kernel")
    flops = kernel_ops(ks, x) + ks.substeps * DYN_G_OPS * sum(ks.movable) * B
    work = ((x.shape[0] + 9 * E) * B * 4, flops)
    del env, seen

    # -- (b) the main path: env.step (the PID in PyTorch, then K1) per step
    F.fused_step_launches = 0
    F.rows_step_launches = 0
    env = make_env("wind_flocking", num_envs=B, fused_physics=True)  # every default: 2 agents, the PID on
    assert env.device.type == "cuda" and env.world.dynamic_gravity
    env.reset()
    rgen = torch.Generator(device=dev).manual_seed(0)
    run = rollout_fn(env, horizon=WFL_HORIZON)
    state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
    launches = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
    assert launches == {"fused_step": WFL_HORIZON * (1 + TIMED_CALLS), "rows_step": 0}, launches
    assert traj["rewards"].shape == (WFL_HORIZON, B, 2) and bool(torch.isfinite(traj["rewards"]).all())
    assert all(o.shape == (WFL_HORIZON, B, 4) and bool(torch.isfinite(o).all()) for o in traj["obs"])
    assert bool(torch.isfinite(state.pos).all()) and bool(torch.isfinite(state.dyn_gravity).all())
    print(f"main path: wind_flocking {B} envs x 2 agents x {WFL_HORIZON} env.step calls; launches {launches}",
          flush=True)
    rollout_report("wind_flocking rollout_fn", run, state, steps, rgen, call_ms, warm_s, B, card,
                   horizon=WFL_HORIZON)
    entry = kernel_entry(key, "vmas_tpu_torch/csrc/fused_step.cu", "vmas_tpu/core/fused.py:1425",
                         launches["fused_step"], 0.0, times, *work)
    return [entry]


# -- MPE: simple and simple_spread ------------------------------------------------

def mpe_phase(card, dev):
    """simple_spread's and simple's two kernel forms against their plain
    versions, bitwise; a 4-step launch against 4 launches of one;
    simple_spread's env.step rollout against its rows rollout, bitwise;
    simple_spread's main path at 4096 and 30000 envs (discrete actions) at
    k_steps 1 and 4; the phase's entries of the kernels line."""
    import numpy as np
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn, rows_rollout_supported

    times, work, entries = {}, {}, []

    def bitwise(tag, got, want):
        if not torch.equal(got, want):
            n = int((got != want).any(0).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"{tag}: kernel and plain version differ in {n} envs")

    # -- (a) K1 and K2 against plain, bitwise --------------------------------------
    for name, B, n_steps in (("simple_spread", NUM_ENVS, MPE_CMP_STEPS), ("simple_spread", MPE_WIDE, 3),
                             ("simple", NUM_ENVS, MPE_CMP_STEPS)):
        env = make_env(name, B, device=dev, seed=0, fused_physics=True, continuous_actions=False)
        world, fo = env.world, env._fused_outputs
        slots = [a.index for a in env.agents]
        ks = F._kernel_spec(world)
        E, A = ks.E, len(slots)
        step = F.make_rows_step(world, fo, slots)
        carry = F.pack_carry(world, state_from_numpy(world, testing.mpe_state(env, np.random.default_rng(52))), fo)
        gen = torch.Generator(device=dev).manual_seed(53)
        acts = lambda: ((torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1)).contiguous()
        contacts = 0
        for t in range(n_steps):
            act = acts()
            x = with_actions(carry, act, slots, E)
            contacts += F.contact_counts(world, x)["ss"]
            c_k, e_k = step(carry, act)
            c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
            bitwise(f"{name}@{B} rows_step carry", c_k, c_p)
            bitwise(f"{name}@{B} rows_step emit", e_k, e_p)
            bitwise(f"{name}@{B} fused_step", F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo))
            carry = c_k
        torch.cuda.synchronize()
        print(f"{name}@{B}: rows_step and fused_step bitwise their plain versions over {n_steps} re-synced steps "
              f"(E {E}, pairs {len(ks.ss)}, sphere-sphere contacts {contacts})", flush=True)
        if name == "simple_spread" and contacts == 0:
            raise AssertionError("the simple_spread comparison saw no contact")
        act = acts()
        x = with_actions(carry, act, slots, E)
        other_form_bitwise(ks, [(lambda: step(carry, act), lambda: F.rows_step_plain(world, fo, slots, carry, act)),
                                (lambda: F.fused_step(world, x, fo), lambda: F.fused_step_plain(world, x, fo))],
                           f"{name}@{B}")
        extra = torch.empty((fo.n_out, B), device=dev)
        tag = "" if B == NUM_ENVS else f",{B}"
        key = f"rows_step[{name}{tag}]"
        times[key] = kernel_times(key, lambda: step(carry, act, extra),
                                  lambda: F.rows_step_plain(world, fo, slots, carry, act), "fused_step_kernel")
        work[key] = ((2 * carry.shape[0] + 2 * A + fo.n_out) * B * 4, kernel_ops(ks, carry, fo, rows_form=True))
        if B == NUM_ENVS:
            key = f"fused_step[{name}]"
            times[key] = kernel_times(key, lambda: F.fused_step(world, x, fo),
                                      lambda: F.fused_step_plain(world, x, fo), "fused_step_kernel")
            work[key] = ((x.shape[0] + 9 * E + fo.n_out) * B * 4, kernel_ops(ks, x, fo))
        if name == "simple_spread" and B == NUM_ENVS:
            # -- (b) one launch of K_STEPS steps against K_STEPS launches of one,
            # and against the plain version's K_STEPS steps, bitwise
            act_k = torch.cat([acts() for _ in range(K_STEPS)]).contiguous()

            def mpe_compare(tr, k, c_k, c_p, e_k, e_p, mid):
                bitwise(f"simple_spread k{K_STEPS} step {k} emit", e_k, e_p)
                if k == K_STEPS - 1:
                    bitwise(f"simple_spread k{K_STEPS} carry", c_k, c_p)
                tr.close("simple_spread k4 emit rows", e_k, e_p)

            k_steps_check(world, fo, slots, carry, act_k, "simple_spread", mpe_compare)
            key = f"rows_step[simple_spread,k{K_STEPS}]"
            step_k = F.make_rows_step(world, fo, slots, k_steps=K_STEPS)
            extra_k = torch.empty((K_STEPS * fo.n_out, B), device=dev)
            times[key] = kernel_times(key, lambda: step_k(carry, act_k, extra_k),
                                      lambda: F.rows_step_plain(world, fo, slots, carry, act_k, K_STEPS),
                                      "fused_step_kernel")
            work[key] = ((2 * carry.shape[0] + K_STEPS * (2 * A + fo.n_out)) * B * 4,
                         K_STEPS * kernel_ops(ks, carry, fo, rows_form=True))
            # -- (c) env.step's rollout (K1) against the rows rollout (K2)
            assert rows_rollout_supported(env)
            s0, st0 = env.state, env.steps
            sa, _, ta = rollout_fn(env, horizon=MPE_CMP_STEPS)(s0, st0, torch.Generator(device=dev).manual_seed(7))
            sb, _, tb = rows_rollout_fn(env, horizon=MPE_CMP_STEPS)(s0, st0,
                                                                   torch.Generator(device=dev).manual_seed(7))
            pairs = {"rewards": [(ta["rewards"], tb["rewards"])], "dones": [(ta["dones"], tb["dones"])],
                     "obs": list(zip(ta["obs"], tb["obs"])), "final pos": [(sa.pos, sb.pos)],
                     "final vel": [(sa.vel, sb.vel)], "final u": list(zip(sa.u, sb.u))}
            differ = [k for k, ps in pairs.items() if not all(torch.equal(a, b) for a, b in ps)]
            print(f"simple_spread env.step rollout vs rows rollout over {MPE_CMP_STEPS} steps (discrete actions): "
                  f"bitwise equal {not differ}", flush=True)
            if differ:
                raise AssertionError(f"simple_spread env.step rollout and rows rollout differ in {differ}")
        del env, carry, x

    # -- (d) the main path at 4096 and 30000 envs, k_steps 1 and 4 --------------------
    launches = {}
    for B, horizon in ((NUM_ENVS, HORIZON), (MPE_WIDE, MPE_WIDE_HORIZON)):
        for k in (1, K_STEPS):
            F.fused_step_launches = 0
            F.rows_step_launches = 0
            env = make_env("simple_spread", num_envs=B, continuous_actions=False, fused_physics=True)
            assert env.device.type == "cuda" and env.n_agents == 3
            obs = env.reset()
            for _ in range(5):
                obs, rews, dones, infos = env.step(env.get_random_actions())
            assert all(o.shape == (B, 14) and bool(torch.isfinite(o).all()) for o in obs)
            rgen = torch.Generator(device=dev).manual_seed(0)
            run = rows_rollout_fn(env, horizon=horizon, k_steps=k)
            state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
            n = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
            assert n == {"fused_step": 5, "rows_step": horizon * (1 + TIMED_CALLS) // k}, n
            assert traj["rewards"].shape == (horizon, B, 3) and bool(torch.isfinite(traj["rewards"]).all())
            assert all(o.shape == (horizon, B, 14) and bool(torch.isfinite(o).all()) for o in traj["obs"])
            assert bool(torch.isfinite(state.pos).all())
            print(f"main path: simple_spread {B} envs x 3 agents x {horizon} steps, discrete actions, k_steps {k}; "
                  f"launches {n}", flush=True)
            rollout_report(f"simple_spread@{B} rows_rollout_fn k_steps {k}", run, state, steps, rgen, call_ms,
                           warm_s, B, card, horizon=horizon)
            launches[(B, k)] = n
            del env, state, traj

    src = "vmas_tpu_torch/csrc/fused_step.cu"
    on = "simple_spread's main path at 4096 envs, k_steps 1"
    for key, site, n, note in (
        ("rows_step[simple_spread]", "1603", launches[(NUM_ENVS, 1)]["rows_step"], None),
        ("fused_step[simple_spread]", "1425", launches[(NUM_ENVS, 1)]["fused_step"], None),
        (f"rows_step[simple_spread,k{K_STEPS}]", "1603", launches[(NUM_ENVS, K_STEPS)]["rows_step"], None),
        (f"rows_step[simple_spread,{MPE_WIDE}]", "1603", launches[(MPE_WIDE, 1)]["rows_step"], None),
        ("rows_step[simple]", "1603", launches[(NUM_ENVS, 1)]["rows_step"], on),
        ("fused_step[simple]", "1425", launches[(NUM_ENVS, 1)]["fused_step"], on),
    ):
        e = kernel_entry(key, src, f"vmas_tpu/core/fused.py:{site}", n, 0.0, times[key], *work[key])
        if note:
            e["launches_on"] = note
        entries.append(e)
    return entries


# -- the rest of the MPE family ------------------------------------------------------

def mpe_family_events(name, fo, extra):
    """The events an emit step's rows show: the catches (simple_tag: a reward
    term of 10; simple_world_comm: an adversary's nonzero reward) and the
    food eaten (simple_world_comm: a good agent's reward above 1)."""
    rew = extra[fo.base:fo.base + fo.n_agents]
    if name == "simple_tag":
        return {"catches": int((rew.abs() > 5).sum())}
    if name == "simple_world_comm":
        adv = torch_mask(fo.adv, rew.device)
        return {"catches": int((rew[adv] != 0).sum()), "food": int((rew[~adv] > 1).sum())}
    return {}


def torch_mask(flags, device):
    import torch

    return torch.tensor(flags, dtype=torch.bool, device=device)


def linear_comm_policy(env, seed):
    """A fixed linear policy on each agent's observations: its physical
    actions in (-1, 1) (tanh), its comm actions in (0, 1) (sigmoid), as
    JAX tests/test_rows_rollout.py's comm policy."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    obs = env._observations(env.state)
    Ws = [torch.tensor(rng.normal(size=(o.shape[-1], env.get_agent_action_size(a))) * 0.2, dtype=torch.float32,
                       device=env.device) for o, a in zip(obs, env.agents)]
    sizes = [a.action_size for a in env.agents]

    def policy(obs, generator):
        return tuple(torch.cat([torch.tanh((o @ W)[:, :n]), torch.sigmoid((o @ W)[:, n:])], -1)
                     for o, W, n in zip(obs, Ws, sizes))

    return policy


def rollouts_bitwise(tag, ta, tb, sa, sb, card):
    """Two rollouts' outputs and final states, bitwise; raises on any
    difference."""
    import torch

    pairs = [("rewards", ta["rewards"], tb["rewards"]), ("dones", ta["dones"], tb["dones"])]
    pairs += [(f"obs[{i}]", a, b) for i, (a, b) in enumerate(zip(ta["obs"], tb["obs"]))]
    pairs += [(f"final {f}", getattr(sa, f), getattr(sb, f)) for f in ("pos", "vel", "force", "c", "uc", "rendering")]
    pairs += [(f"final u[{i}]", a, b) for i, (a, b) in enumerate(zip(sa.u, sb.u))]
    for k, v in sa.scenario.items():
        # a controller's memory is a dict of rows
        items = v.items() if isinstance(v, dict) else [(None, v)]
        pairs += [(f"final scenario[{k}]" + (f"[{k2}]" if k2 else ""), a,
                   sb.scenario[k] if k2 is None else sb.scenario[k][k2]) for k2, a in items]
    differ = [name for name, a, b in pairs if not torch.equal(a, b)]
    print(f"{tag} on {card}: {len(pairs)} outputs, bitwise equal {not differ}", flush=True)
    if differ:
        raise AssertionError(f"{tag}: the rollouts differ in {differ}")


def mpe_family_phase(card, dev):
    """simple_push, simple_adversary, simple_tag, simple_reference,
    simple_speaker_listener and simple_world_comm at 4096 envs: each
    world's K2 and K1 bitwise their plain versions over MPEF_CMP_STEPS
    re-synced steps from a state with catches, contacts and food in reach,
    at the rule's lanes and at the other form, and a 4-step launch bitwise 4
    launches of one; the rows rollout bitwise the env.step rollout for
    simple_tag, simple_world_comm and simple_reference (the comm state
    given to unpack per step), and simple_reference's rows policy rollout
    bitwise its env.step policy rollout with continuous comm; then each
    world's main path (rows_rollout_fn, horizon 1000 for simple_tag and
    simple_world_comm, 100 for the others, k_steps 1 and 4) and
    simple_crypto's (rollout_fn, 100 steps); the phase's entries of the
    kernels line."""
    import numpy as np
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_policy_rollout_fn, rows_rollout_fn

    times, work, errs = {}, {}, {}
    B = NUM_ENVS
    # -- (a) K2 and K1 against plain, bitwise, at both forms; k_steps ---------------
    for name in MPEF_WORLDS:
        env = make_env(name, B, device=dev, seed=0, fused_physics=True)
        world, fo = env.world, env._fused_outputs
        slots = [a.index for a in env.agents]
        ks = F._kernel_spec(world)
        E, A = ks.E, len(slots)
        step = F.make_rows_step(world, fo, slots)
        carry = F.pack_carry(world, state_from_numpy(world, testing.mpe_family_state(env, np.random.default_rng(70))),
                             fo)
        gen = torch.Generator(device=dev).manual_seed(71)
        acts = lambda: (torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1).contiguous()
        k2, k1 = ErrTracker(), ErrTracker()
        contacts, events = 0, {}
        for t in range(MPEF_CMP_STEPS):
            act = acts()
            x = with_actions(carry, act, slots, E)
            contacts += F.contact_counts(world, x)["ss"]
            c_k, e_k = step(carry, act)
            c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
            compare_rows(k2, c_k, c_p, e_k, e_p, f"{name} rows_step")
            y_k, y_p = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
            compare_rows(k1, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], f"{name} fused_step")
            for k, v in mpe_family_events(name, fo, e_p).items():
                events[k] = events.get(k, 0) + v
            carry = c_k
        torch.cuda.synchronize()
        print(f"{name}@{B}: rows_step and fused_step bitwise their plain versions over {MPEF_CMP_STEPS} re-synced "
              f"steps at {ks.lanes} lane{'s' if ks.lanes > 1 else ''} per env (E {E}, sphere-sphere pairs "
              f"{len(ks.ss)}, contacts {contacts}, {events}) on {card}", flush=True)
        if name in MPEF_LONG and (contacts == 0 or 0 in events.values()):
            raise AssertionError(f"the {name} comparison saw no contact, catch or food eaten: {contacts}, {events}")
        errs[f"rows_step[{name}]"], errs[f"fused_step[{name}]"] = k2.max(), k1.max()
        act = acts()
        x = with_actions(carry, act, slots, E)
        other_form_bitwise(ks, [(lambda: step(carry, act), lambda: F.rows_step_plain(world, fo, slots, carry, act)),
                                (lambda: F.fused_step(world, x, fo), lambda: F.fused_step_plain(world, x, fo))],
                           f"{name}@{B}")
        act_k = torch.cat([acts() for _ in range(K_STEPS)]).contiguous()

        def compare(tr, k, c_k, c_p, e_k, e_p, mid, name=name):
            tr.close(f"{name} k{K_STEPS} step {k} emit rows", e_k, e_p)
            if k == K_STEPS - 1:
                tr.close(f"{name} k{K_STEPS} carry", c_k, c_p)

        k_steps_check(world, fo, slots, carry, act_k, f"{name}@{B}", compare)
        extra = torch.empty((fo.n_out, B), device=dev)
        key = f"rows_step[{name}]"
        times[key] = kernel_times(key, lambda: step(carry, act, extra),
                                  lambda: F.rows_step_plain(world, fo, slots, carry, act), "fused_step_kernel")
        work[key] = ((2 * carry.shape[0] + 2 * A + fo.n_out) * B * 4, kernel_ops(ks, carry, fo, rows_form=True))
        key = f"fused_step[{name}]"
        times[key] = kernel_times(key, lambda: F.fused_step(world, x, fo), lambda: F.fused_step_plain(world, x, fo),
                                  "fused_step_kernel")
        work[key] = ((x.shape[0] + 9 * E + fo.n_out) * B * 4, kernel_ops(ks, x, fo))
        # the rows step at the form the rule does not pick, for the rule's check
        other = 8 if ks.lanes == 1 else 1
        other_ms = at_lanes(ks, other, lambda: launch_ms(lambda: step(carry, act, extra), 200, "fused_step_kernel",
                                                         "the other form"))
        times[f"rows_step[{name}]"]["other"] = (other, other_ms)
        print(f"rows_step[{name}] at {other} lane{'s' if other > 1 else ''} per env: {other_ms * 1e3:.3f} us on the "
              f"device (the rule's {ks.lanes}: {times[f'rows_step[{name}]']['ms'] * 1e3:.3f} us)", flush=True)
        del env, carry, x

    # -- (b) the rows rollouts against the env.step rollouts, bitwise --------------
    for name in ("simple_tag", "simple_world_comm", "simple_reference"):
        env = make_env(name, B, device=dev, seed=0, fused_physics=True)
        s0, st0 = env.state, env.steps
        sa, _, ta = rollout_fn(env, horizon=MPEF_ROLLOUT_STEPS)(s0, st0, torch.Generator(device=dev).manual_seed(7))
        sb, _, tb = rows_rollout_fn(env, horizon=MPEF_ROLLOUT_STEPS)(s0, st0,
                                                                     torch.Generator(device=dev).manual_seed(7))
        rollouts_bitwise(f"{name}@{B} env.step rollout vs rows rollout over {MPEF_ROLLOUT_STEPS} steps", ta, tb, sa,
                         sb, card)
        if name == "simple_reference":
            policy = linear_comm_policy(env, 3)
            sa, _, ta = rollout_fn(env, policy, MPEF_ROLLOUT_STEPS)(s0, st0, torch.Generator(device=dev).manual_seed(23))
            sb, _, tb = rows_policy_rollout_fn(env, policy, MPEF_ROLLOUT_STEPS)(
                s0, st0, torch.Generator(device=dev).manual_seed(23))
            if torch.equal(ta["obs"][0][-1, :, -10:], ta["obs"][0][0, :, -10:]):
                raise AssertionError("simple_reference's observed comm did not change over the policy rollout")
            rollouts_bitwise(f"simple_reference@{B} env.step policy rollout vs rows policy rollout (continuous "
                             f"comm, a linear policy) over {MPEF_ROLLOUT_STEPS} steps", ta, tb, sa, sb, card)
        del env

    # -- (c) the main paths: each world's rows rollout at k_steps 1 and 4 -------------
    launches = {}
    for name in MPEF_WORLDS:
        horizon = HORIZON if name in MPEF_LONG else MPEF_SHORT_HORIZON
        for k in (1, K_STEPS):
            F.fused_step_launches = 0
            F.rows_step_launches = 0
            env = make_env(name, num_envs=B, fused_physics=True)
            assert env.device.type == "cuda"
            obs = env.reset()
            for _ in range(5):
                obs, rews, dones, infos = env.step(env.get_random_actions())
            rgen = torch.Generator(device=dev).manual_seed(0)
            run = rows_rollout_fn(env, horizon=horizon, k_steps=k)
            state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
            n = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
            assert n == {"fused_step": 5, "rows_step": horizon * (1 + TIMED_CALLS) // k}, n
            widths = [o.shape[-1] for o in obs]
            assert traj["rewards"].shape == (horizon, B, env.n_agents) and bool(torch.isfinite(traj["rewards"]).all())
            assert all(o.shape == (horizon, B, w) and bool(torch.isfinite(o).all()) for o, w in zip(traj["obs"], widths))
            assert bool(torch.isfinite(state.pos).all())
            print(f"main path: {name} {B} envs x {env.n_agents} agents x {horizon} steps, k_steps {k}; launches {n}",
                  flush=True)
            rollout_report(f"{name}@{B} rows_rollout_fn k_steps {k}", run, state, steps, rgen, call_ms, warm_s, B, card,
                           horizon=horizon)
            launches[(name, k)] = n
            del env, state, traj
    F.fused_step_launches = 0
    F.rows_step_launches = 0
    env = make_env("simple_crypto", num_envs=B)
    rgen = torch.Generator(device=dev).manual_seed(0)
    run = rollout_fn(env, horizon=MPEF_SHORT_HORIZON)
    state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
    n = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
    assert n == {"fused_step": 0, "rows_step": 0}, n
    assert traj["rewards"].shape == (MPEF_SHORT_HORIZON, B, 3) and bool(torch.isfinite(traj["rewards"]).all())
    assert [o.shape for o in traj["obs"]] == [(MPEF_SHORT_HORIZON, B, w) for w in (4, 8, 8)]
    assert all(bool(torch.isfinite(o).all()) for o in traj["obs"]) and bool((traj["rewards"] != 0).any())
    print(f"main path: simple_crypto {B} envs x 3 agents x {MPEF_SHORT_HORIZON} steps through rollout_fn (the hook "
          f"pipeline, no fused step); launches {n}", flush=True)
    rollout_report(f"simple_crypto@{B} rollout_fn", run, state, steps, rgen, call_ms, warm_s, B, card,
                   horizon=MPEF_SHORT_HORIZON, trace=(rollout_fn(env, horizon=HOOK_TRACE_STEPS), HOOK_TRACE_STEPS))
    del env, state, traj

    entries = []
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    for name in MPEF_WORLDS:
        n = launches[(name, 1)]
        for form, site in (("rows_step", "1603"), ("fused_step", "1425")):
            key = f"{form}[{name}]"
            e = kernel_entry(key, src, f"vmas_tpu/core/fused.py:{site}", n[form], errs[key], times[key], *work[key])
            e["launches_on"] = f"{name}'s main path at {NUM_ENVS} envs, k_steps 1"
            if "other" in times[key]:
                e["other_lanes"], e["other_us"] = times[key]["other"][0], times[key]["other"][1] * 1e3
            entries.append(e)
    return entries


# -- the other holonomic worlds -------------------------------------------------------

# the counts a comparison must see above zero, per world
HOL_REQUIRED = {
    "reverse_transport": ("bs",), "wheel": ("ls",), "passage": ("bs", "agent_hits", "wall_hits"),
    "dispersion": ("food_eaten",), "dropout": ("goal_eaten",), "het_mass": (),
}


def holonomic_phase(card, dev):
    """reverse_transport, wheel, passage, dispersion, dropout and het_mass at
    4096 envs: each world's K2 (but het_mass's, which has none) and K1
    bitwise their plain versions over HOL_CMP_STEPS re-synced steps from
    testing.holonomic_state, at the rule's lanes and at the other form, with
    the contacts and events counted (box-sphere contacts, line-sphere
    contacts, passage's wall and agent hits, food and goal eaten), and a
    4-step launch bitwise 4 launches of one; dispersion's and dropout's rows
    rollouts (post_rewards once at the end; each step's u read by unpack)
    and wheel's rows policy rollout with its HeuristicPolicy bitwise their
    env.step rollouts over HOL_ROLLOUT_STEPS steps; then each world's main
    path (rows_rollout_fn at k_steps 1 and 4, horizon 1000 for passage and
    reverse_transport and 100 for the others; het_mass: 5 env.step and
    rollout_fn, 100 steps); the phase's entries of the kernels line."""
    import numpy as np
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.heuristic_policy import rollout_policy
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_policy_rollout_fn, rows_rollout_fn
    from vmas_tpu_torch.scenarios.wheel import HeuristicPolicy as WheelPolicy

    times, work, errs = {}, {}, {}
    B = NUM_ENVS
    # -- (a) K2 and K1 against plain, bitwise, at both forms; k_steps ---------------
    for name in HOL_WORLDS:
        env = make_env(name, B, device=dev, seed=0, fused_physics=True)
        world, fo = env.world, env._fused_outputs
        slots = [a.index for a in env.agents]
        ks = F._kernel_spec(world)
        E, A = ks.E, len(slots)
        rows = F.rows_step_supported(world, fo, env.agents)
        st = state_from_numpy(world, testing.holonomic_state(env, np.random.default_rng(80)))
        carry = F.pack_carry(world, st, fo)
        x0 = torch.cat([F.state_rows(st), st.joint_fixed_rot.T, fo.scratch_rows(st)]).contiguous()
        step = F.make_rows_step(world, fo, slots) if rows else None
        gen = torch.Generator(device=dev).manual_seed(81)
        acts = lambda: (torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1).contiguous()
        k2, k1 = ErrTracker(), ErrTracker()
        counts = {}
        x = x0
        for t in range(HOL_CMP_STEPS):
            act = acts()
            if rows:
                c_k, e_k = step(carry, act)
                c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
                compare_rows(k2, c_k, c_p, e_k, e_p, f"{name} rows_step")
                carry = c_k
            for k, v in F.contact_counts(world, x).items():
                counts[k] = counts.get(k, 0) + v
            y_k, y_p = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
            compare_rows(k1, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], f"{name} fused_step")
            for k, v in testing.holonomic_events(env, y_p[:9 * E], y_p[9 * E:]).items():
                counts[k] = counts.get(k, 0) + v
            # the next step from the kernel's state, with this step's
            # scratch as env.step's unpack would leave it
            x = with_actions(torch.cat([y_k[:9 * E], x[9 * E:]]), act, slots, E).contiguous()
        torch.cuda.synchronize()
        shown = {k: v for k, v in counts.items() if v or k in HOL_REQUIRED[name]}
        print(f"{name}@{B}: {'rows_step and ' if rows else ''}fused_step bitwise their plain versions over "
              f"{HOL_CMP_STEPS} re-synced steps at {ks.lanes} lane{'s' if ks.lanes > 1 else ''} per env (E {E}, "
              f"pairs {dict((t, len(getattr(ks, t))) for t in F.PAIR_TYPES if getattr(ks, t))}; contacts and "
              f"events {shown}) on {card}", flush=True)
        missing = [k for k in HOL_REQUIRED[name] if not counts.get(k)]
        if missing:
            raise AssertionError(f"the {name} comparison saw none of {missing}: {counts}")
        errs[f"fused_step[{name}]"] = k1.max()
        act = acts()
        x = with_actions(x0, act, slots, E).contiguous()
        pairs = [(lambda: F.fused_step(world, x, fo), lambda: F.fused_step_plain(world, x, fo))]
        if rows:
            errs[f"rows_step[{name}]"] = k2.max()
            pairs.append((lambda: step(carry, act), lambda: F.rows_step_plain(world, fo, slots, carry, act)))
        other_form_bitwise(ks, pairs, f"{name}@{B}")
        if rows:
            act_k = torch.cat([acts() for _ in range(K_STEPS)]).contiguous()

            def compare(tr, k, c_k, c_p, e_k, e_p, mid, name=name):
                tr.close(f"{name} k{K_STEPS} step {k} emit rows", e_k, e_p)
                if k == K_STEPS - 1:
                    tr.close(f"{name} k{K_STEPS} carry", c_k, c_p)

            k_steps_check(world, fo, slots, carry, act_k, f"{name}@{B}", compare)
            extra = torch.empty((fo.n_out, B), device=dev)
            key = f"rows_step[{name}]"
            times[key] = kernel_times(key, lambda: step(carry, act, extra),
                                      lambda: F.rows_step_plain(world, fo, slots, carry, act), "fused_step_kernel")
            work[key] = ((2 * carry.shape[0] + 2 * A + fo.n_out) * B * 4, kernel_ops(ks, carry, fo, rows_form=True))
        key = f"fused_step[{name}]"
        times[key] = kernel_times(key, lambda: F.fused_step(world, x, fo), lambda: F.fused_step_plain(world, x, fo),
                                  "fused_step_kernel")
        work[key] = ((x.shape[0] + 9 * E + fo.n_out) * B * 4, kernel_ops(ks, x, fo))
        # the rule's form against the other one, for the rule's check
        other = 8 if ks.lanes == 1 else 1
        form = (f"rows_step[{name}]", lambda: step(carry, act, extra)) if rows else (key, lambda: F.fused_step(
            world, x, fo))
        other_ms = at_lanes(ks, other, lambda: launch_ms(form[1], 200, "fused_step_kernel", "the other form"))
        times[form[0]]["other"] = (other, other_ms)
        print(f"{form[0]} at {other} lane{'s' if other > 1 else ''} per env: {other_ms * 1e3:.3f} us on the device "
              f"(the rule's {ks.lanes}: {times[form[0]]['ms'] * 1e3:.3f} us)", flush=True)
        del env, carry, x, x0

    # -- (b) the rows rollouts against the env.step rollouts, bitwise --------------
    for name in ("dispersion", "dropout"):
        env = make_env(name, B, device=dev, seed=0, fused_physics=True)
        s0 = state_from_numpy(env.world, testing.holonomic_state(env, np.random.default_rng(82)))
        st0 = env.steps
        sa, _, ta = rollout_fn(env, horizon=HOL_ROLLOUT_STEPS)(s0, st0, torch.Generator(device=dev).manual_seed(7))
        sb, _, tb = rows_rollout_fn(env, horizon=HOL_ROLLOUT_STEPS)(s0, st0,
                                                                    torch.Generator(device=dev).manual_seed(7))
        what = "post_rewards once at the end" if name == "dispersion" else "each step's u read by unpack"
        rollouts_bitwise(f"{name}@{B} env.step rollout vs rows rollout ({what}) over {HOL_ROLLOUT_STEPS} steps",
                         ta, tb, sa, sb, card)
        del env
    env = make_env("wheel", B, device=dev, seed=0, fused_physics=True)
    policy = rollout_policy(env, WheelPolicy(True))
    s0, st0 = env.state, env.steps
    sa, _, ta = rollout_fn(env, policy, HOL_ROLLOUT_STEPS)(s0, st0, torch.Generator(device=dev).manual_seed(23))
    sb, _, tb = rows_policy_rollout_fn(env, policy, HOL_ROLLOUT_STEPS)(s0, st0,
                                                                       torch.Generator(device=dev).manual_seed(23))
    rollouts_bitwise(f"wheel@{B} env.step policy rollout vs rows policy rollout (its HeuristicPolicy) over "
                     f"{HOL_ROLLOUT_STEPS} steps", ta, tb, sa, sb, card)
    del env

    # -- (c) the main paths: each world's rows rollout at k_steps 1 and 4 -------------
    launches = {}
    for name in HOL_WORLDS:
        horizon = HORIZON if name in HOL_LONG else HOL_SHORT_HORIZON
        for k in ((1, K_STEPS) if name != "het_mass" else (1,)):
            F.fused_step_launches = 0
            F.rows_step_launches = 0
            env = make_env(name, num_envs=B, fused_physics=True)
            assert env.device.type == "cuda"
            obs = env.reset()
            for _ in range(5):
                obs, rews, dones, infos = env.step(env.get_random_actions())
            rgen = torch.Generator(device=dev).manual_seed(0)
            run = rows_rollout_fn(env, horizon=horizon, k_steps=k) if name != "het_mass" else rollout_fn(
                env, horizon=horizon)
            state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
            n = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
            want = ({"fused_step": 5, "rows_step": horizon * (1 + TIMED_CALLS) // k} if name != "het_mass" else
                    {"fused_step": 5 + horizon * (1 + TIMED_CALLS), "rows_step": 0})
            assert n == want, (name, n, want)
            widths = [o.shape[-1] for o in obs]
            assert traj["rewards"].shape == (horizon, B, env.n_agents) and bool(torch.isfinite(traj["rewards"]).all())
            assert all(o.shape == (horizon, B, w) and bool(torch.isfinite(o).all()) for o, w in zip(traj["obs"], widths))
            assert bool(torch.isfinite(state.pos).all())
            path = f"rows_rollout_fn k_steps {k}" if name != "het_mass" else "rollout_fn (env.step: K1)"
            print(f"main path: {name} {B} envs x {env.n_agents} agents x {horizon} steps, {path}; launches {n}",
                  flush=True)
            rollout_report(f"{name}@{B} {path}", run, state, steps, rgen, call_ms, warm_s, B, card, horizon=horizon,
                           trace=(rollout_fn(env, horizon=HOOK_TRACE_STEPS), HOOK_TRACE_STEPS)
                           if name == "het_mass" else None)
            launches[(name, k)] = n
            del env, state, traj

    entries = []
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    for name in HOL_WORLDS:
        n = launches[(name, 1)]
        for form, site in (("rows_step", "1603"), ("fused_step", "1425")):
            key = f"{form}[{name}]"
            if key not in times:
                continue
            e = kernel_entry(key, src, f"vmas_tpu/core/fused.py:{site}", n[form], errs[key], times[key], *work[key])
            e["launches_on"] = (f"{name}'s main path at {NUM_ENVS} envs, "
                                + ("k_steps 1" if name != "het_mass" else "rollout_fn"))
            if "other" in times[key]:
                e["other_lanes"], e["other_us"] = times[key]["other"][0], times[key]["other"][1] * 1e3
            entries.append(e)
    return entries


# -- the joint worlds ------------------------------------------------------------------

# the counts a comparison must see above zero, per world
JW_REQUIRED = {
    "buzz_wire": ("ls", "joints", "line_hits", "line_band", "done"),
    "ball_trajectory": ("ss", "joints"),
    "ball_passage": ("ss", "bs", "box_hits", "done"),
    "joint_passage_size": ("ls", "bs", "joints", "just_passed", "done"),
}


def noisy_env(config, B, dev):
    """An env of a NOISY config on ``dev``, its agents' noise set."""
    import numpy as np
    from vmas_tpu_torch import make_env

    name, kw, noise = NOISY[config]
    env = make_env(name, B, device=dev, seed=0, fused_physics=True, **kw)
    for a in env.agents:
        if noise is not None:
            a.u_noise_array = np.full_like(a.u_noise_array, 0.1)
        if noise == "uc" and not a.silent:
            a.c_noise = 0.2
    return env


def joint_worlds_phase(card, dev):
    """buzz_wire, ball_trajectory, ball_passage and joint_passage_size at
    4096 envs (and joint_passage_size with its velocity controller, its PID
    in K2): each world's K2 and K1 bitwise their plain versions over
    JW_CMP_STEPS re-synced steps from testing.joint_worlds_state, at the
    rule's lanes and at the other form, with the contacts, joint-force
    lanes, line and box hits, just_passed and done counted (and required),
    and a 4-step launch bitwise 4 launches of one; asym_joint's K1 (no emit)
    bitwise its plain version along env.step calls; each world's env.step
    rollout bitwise its rows rollout over JW_ROLLOUT_STEPS steps
    (joint_passage_size's ``t`` finale and PID memory included); the noisy
    configs (NOISY) on both rows paths bitwise rollout_fn at k_steps 1 and
    4, with resets every 10 steps and with a policy; then each world's main
    path (rows_rollout_fn at k_steps 1 and 4, horizon 1000;
    joint_passage_size+pid at k_steps 1; asym_joint: 5 env.step and
    rollout_fn, 100 steps); a noisy config's rows rollout and its
    rollout_fn at horizon 1000, timed; the phase's entries of the kernels
    line."""
    import numpy as np
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import (
        _chunked_reset_rollout,
        rollout_fn,
        rows_policy_rollout_fn,
        rows_rollout_fn,
    )

    times, work, errs = {}, {}, {}
    B = NUM_ENVS
    configs = [(name, name, {}) for name in JW_WORLDS]
    configs.append(("joint_passage_size+pid", "joint_passage_size", {"use_vel_controller": True}))
    # -- (a) K2 and K1 against plain, bitwise, at both forms; k_steps ---------------
    for key, name, kw in configs:
        env = make_env(name, B, device=dev, seed=0, fused_physics=True, **kw)
        world, fo = env.world, env._fused_outputs
        slots = [a.index for a in env.agents]
        ks = F._kernel_spec(world)
        E, A = ks.E, len(slots)
        pid = bool(fo.n_ctrl)
        st = state_from_numpy(world, testing.joint_worlds_state(env, np.random.default_rng(90)))
        carry = F.pack_carry(world, st, fo)
        x0 = torch.cat([F.state_rows(st), st.joint_fixed_rot.T, fo.scratch_rows(st)]).contiguous()
        step = F.make_rows_step(world, fo, slots)
        gen = torch.Generator(device=dev).manual_seed(91)
        acts = lambda: (torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1).contiguous()
        k2, k1 = ErrTracker(), ErrTracker()
        counts = {}

        def count(d):
            for k, v in d.items():
                counts[k] = counts.get(k, 0) + v

        x = x0
        for t in range(JW_CMP_STEPS):
            act = acts()
            xs = with_actions(carry, act, slots, E)
            count(F.contact_counts(world, xs))
            count({"joints": F.joint_counts(world, xs)["force"]})
            c_k, e_k = step(carry, act)
            c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
            compare_rows(k2, c_k, c_p, e_k, e_p, f"{key} rows_step")
            count(testing.joint_worlds_events(env, e_p[:fo.n_out], c_p[:9 * E]))
            carry = c_k
            if not pid:
                y_k, y_p = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
                compare_rows(k1, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], f"{key} fused_step")
                x = with_actions(torch.cat([y_k[:9 * E], x[9 * E:]]), act, slots, E).contiguous()
        torch.cuda.synchronize()
        required = JW_REQUIRED[name]
        shown = {k: v for k, v in counts.items() if v or k in required}
        print(f"{key}@{B}: rows_step{'' if pid else ' and fused_step'} bitwise their plain versions over "
              f"{JW_CMP_STEPS} re-synced steps at {ks.lanes} lane{'s' if ks.lanes > 1 else ''} per env (E {E}, "
              f"joints {ks.J}, pairs {dict((t, len(getattr(ks, t))) for t in F.PAIR_TYPES if getattr(ks, t))}; "
              f"contacts, joint-force lanes and events {shown}) on {card}", flush=True)
        missing = [k for k in required if not counts.get(k)]
        if missing:
            raise AssertionError(f"the {key} comparison saw none of {missing}: {counts}")
        errs[f"rows_step[{key}]"] = k2.max()
        act = acts()
        x = with_actions(x0, act, slots, E).contiguous()
        pairs = [(lambda: step(carry, act), lambda: F.rows_step_plain(world, fo, slots, carry, act))]
        if not pid:
            errs[f"fused_step[{key}]"] = k1.max()
            pairs.append((lambda: F.fused_step(world, x, fo), lambda: F.fused_step_plain(world, x, fo)))
        other_form_bitwise(ks, pairs, f"{key}@{B}")
        act_k = torch.cat([acts() for _ in range(K_STEPS)]).contiguous()

        def compare(tr, k, c_k, c_p, e_k, e_p, mid, key=key):
            tr.close(f"{key} k{K_STEPS} step {k} output rows", e_k, e_p)
            if k == K_STEPS - 1:
                tr.close(f"{key} k{K_STEPS} carry", c_k, c_p)

        k_steps_check(world, fo, slots, carry, act_k, f"{key}@{B}", compare)
        extra = torch.empty((fo.n_out + fo.n_ctrl_out, B), device=dev)
        rkey = f"rows_step[{key}]"
        times[rkey] = kernel_times(rkey, lambda: step(carry, act, extra),
                                   lambda: F.rows_step_plain(world, fo, slots, carry, act), "fused_step_kernel")
        work[rkey] = ((2 * carry.shape[0] + 2 * A + fo.n_out + fo.n_ctrl_out) * B * 4,
                      kernel_ops(ks, carry, fo, rows_form=True))
        if not pid:
            fkey = f"fused_step[{key}]"
            times[fkey] = kernel_times(fkey, lambda: F.fused_step(world, x, fo),
                                       lambda: F.fused_step_plain(world, x, fo), "fused_step_kernel")
            work[fkey] = ((x.shape[0] + 9 * E + fo.n_out) * B * 4, kernel_ops(ks, x, fo))
        # the rows step at the form the rule does not pick, for the rule's check
        other = 8 if ks.lanes == 1 else 1
        other_ms = at_lanes(ks, other, lambda: launch_ms(lambda: step(carry, act, extra), 200,
                                                         "fused_step_kernel", "the other form"))
        times[rkey]["other"] = (other, other_ms)
        print(f"{rkey} at {other} lane{'s' if other > 1 else ''} per env: {other_ms * 1e3:.3f} us on the device "
              f"(the rule's {ks.lanes}: {times[rkey]['ms'] * 1e3:.3f} us)", flush=True)
        del env, carry, x, x0

    # asym_joint: K1 with no emit on the rows of env.step calls (its hooks
    # run around it)
    env = make_env("asym_joint", B, device=dev, seed=0, fused_physics=True)
    world = env.world
    ks = F._kernel_spec(world)
    E = ks.E
    assert env._fused_outputs is None and world.fused
    k1 = ErrTracker()
    joint_lanes = 0
    for t in range(JW_CMP_STEPS):
        env.step(env.get_random_actions())
        x = torch.cat([F.state_rows(env.state), env.state.joint_fixed_rot.T]).contiguous()
        joint_lanes += F.joint_counts(world, x)["force"]
        k1.close("asym_joint fused_step state rows", F.fused_step(world, x), F.fused_step_plain(world, x))
    print(f"asym_joint@{B}: fused_step (no emit) bitwise its plain version on the rows of {JW_CMP_STEPS} env.step "
          f"calls at {ks.lanes} lane{'s' if ks.lanes > 1 else ''} per env (E {E}, joints {ks.J}; joint-force lanes "
          f"{joint_lanes}) on {card}", flush=True)
    if not joint_lanes:
        raise AssertionError("the asym_joint comparison saw no joint force")
    key = "fused_step[asym_joint]"
    errs[key] = k1.max()
    other_form_bitwise(ks, [(lambda: F.fused_step(world, x), lambda: F.fused_step_plain(world, x))], f"asym_joint@{B}")
    times[key] = kernel_times(key, lambda: F.fused_step(world, x), lambda: F.fused_step_plain(world, x),
                              "fused_step_kernel")
    work[key] = ((x.shape[0] + 9 * E) * B * 4, kernel_ops(ks, x))
    other = 8 if ks.lanes == 1 else 1
    other_ms = at_lanes(ks, other, lambda: launch_ms(lambda: F.fused_step(world, x), 200, "fused_step_kernel",
                                                     "the other form"))
    times[key]["other"] = (other, other_ms)
    print(f"{key} at {other} lane{'s' if other > 1 else ''} per env: {other_ms * 1e3:.3f} us on the device (the "
          f"rule's {ks.lanes}: {times[key]['ms'] * 1e3:.3f} us)", flush=True)
    del env

    # -- (b) the rows rollouts against the env.step rollouts, bitwise --------------
    for key, name, kw in configs:
        env = make_env(name, B, device=dev, seed=0, fused_physics=True, **kw)
        s0 = state_from_numpy(env.world, testing.joint_worlds_state(env, np.random.default_rng(92)))
        st0 = env.steps
        sa, _, ta = rollout_fn(env, horizon=JW_ROLLOUT_STEPS)(s0, st0, torch.Generator(device=dev).manual_seed(7))
        sb, _, tb = rows_rollout_fn(env, horizon=JW_ROLLOUT_STEPS)(s0, st0,
                                                                   torch.Generator(device=dev).manual_seed(7))
        rollouts_bitwise(f"{key}@{B} env.step rollout vs rows rollout over {JW_ROLLOUT_STEPS} steps", ta, tb, sa, sb,
                         card)
        if name == "joint_passage_size" and not torch.equal(sb.scenario["t"], s0.scenario["t"] + JW_ROLLOUT_STEPS):
            raise AssertionError("joint_passage_size's t clock is not its start value plus the horizon")
        del env

    # -- (c) the noisy configs on both rows paths, bitwise rollout_fn --------------
    H = JW_ROLLOUT_STEPS
    for config in NOISY:
        env = noisy_env(config, B, dev)
        s0, st0 = env.state, env.steps

        def both(ref, rows, seed):
            out = []
            for run in (ref, rows):
                env.scenario.obs_seed = 3
                out.append(run(s0, st0, torch.Generator(device=dev).manual_seed(seed)) + (env.scenario.obs_seed,))
            (sa, _, ta, oa), (sb, _, tb, ob) = out
            if oa != ob:
                raise AssertionError(f"{config}: the rollouts leave different observation seeds")
            return ta, tb, sa, sb

        for k in (1, K_STEPS):
            rollouts_bitwise(f"{config}@{B} rollout_fn vs rows_rollout_fn k_steps {k} over {H} steps",
                             *both(rollout_fn(env, horizon=H), rows_rollout_fn(env, horizon=H, k_steps=k), 11), card)
        rollouts_bitwise(f"{config}@{B} rollout_fn vs rows_rollout_fn with resets every 10 steps",
                         *both(_chunked_reset_rollout(env, rollout_fn(env, horizon=10), H, 10),
                               rows_rollout_fn(env, horizon=H, k_steps=2, reset_every=10), 12), card)
        policy = linear_comm_policy(env, 5)
        rollouts_bitwise(f"{config}@{B} rollout_fn vs rows_policy_rollout_fn (a linear policy) over {H} steps",
                         *both(rollout_fn(env, policy, H), rows_policy_rollout_fn(env, policy, H), 13), card)
        del env

    # -- (d) the main paths: each world's rows rollout at k_steps 1 and 4 -------------
    launches = {}
    runs = [(key, name, kw, k) for key, name, kw in configs for k in ((1, K_STEPS) if key in JW_WORLDS else (1,))]
    runs.append(("asym_joint", "asym_joint", {}, 1))
    for key, name, kw, k in runs:
        horizon = HORIZON if name != "asym_joint" else JW_SHORT_HORIZON
        F.fused_step_launches = 0
        F.rows_step_launches = 0
        env = make_env(name, num_envs=B, fused_physics=True, **kw)
        assert env.device.type == "cuda"
        obs = env.reset()
        for _ in range(5):
            obs, rews, dones, infos = env.step(env.get_random_actions())
        rgen = torch.Generator(device=dev).manual_seed(0)
        rows = name != "asym_joint"
        run = rows_rollout_fn(env, horizon=horizon, k_steps=k) if rows else rollout_fn(env, horizon=horizon)
        state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
        n = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
        want = ({"fused_step": 5, "rows_step": horizon * (1 + TIMED_CALLS) // k} if rows else
                {"fused_step": 5 + horizon * (1 + TIMED_CALLS), "rows_step": 0})
        assert n == want, (key, n, want)
        widths = [o.shape[-1] for o in obs]
        assert traj["rewards"].shape == (horizon, B, env.n_agents) and bool(torch.isfinite(traj["rewards"]).all())
        assert all(o.shape == (horizon, B, w) and bool(torch.isfinite(o).all()) for o, w in zip(traj["obs"], widths))
        assert bool(torch.isfinite(state.pos).all())
        path = f"rows_rollout_fn k_steps {k}" if rows else "rollout_fn (env.step: K1 with no emit)"
        print(f"main path: {key} {B} envs x {env.n_agents} agents x {horizon} steps, {path}; launches {n}",
              flush=True)
        rollout_report(f"{key}@{B} {path}", run, state, steps, rgen, call_ms, warm_s, B, card, horizon=horizon,
                       trace=None if rows else (rollout_fn(env, horizon=HOOK_TRACE_STEPS), HOOK_TRACE_STEPS))
        launches[(key, k)] = n
        del env, state, traj

    # -- (e) a noisy config at the main path's horizon on the rows path that
    # rollout() now takes (its unpack once a step) and on rollout_fn
    config = "joint_passage_size,noise"
    for path in ("rows_rollout_fn k_steps 1", "rollout_fn"):
        F.fused_step_launches = 0
        F.rows_step_launches = 0
        env = noisy_env(config, B, dev)
        run = rows_rollout_fn(env, horizon=HORIZON) if path != "rollout_fn" else rollout_fn(env, horizon=HORIZON)
        rgen = torch.Generator(device=dev).manual_seed(0)
        state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen, calls=NOISY_CALLS)
        n = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
        calls = HORIZON * (1 + NOISY_CALLS)
        want = {"fused_step": 0, "rows_step": calls} if path != "rollout_fn" else {"fused_step": calls, "rows_step": 0}
        assert n == want, (config, path, n, want)
        assert bool(torch.isfinite(traj["rewards"]).all()) and all(bool(torch.isfinite(o).all()) for o in traj["obs"])
        print(f"noisy main path: {config}@{B} x {HORIZON} steps, {path}: calls {[round(c, 3) for c in call_ms]} ms "
              f"(warm-up {warm_s:.3f} s), best {B * HORIZON / (min(call_ms) / 1e3):.1f} env-steps/s on {card}; "
              f"launches {n}", flush=True)
        del env, state, traj

    entries = []
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    for key in [c[0] for c in configs] + ["asym_joint"]:
        n = launches[(key, 1)]
        for form, site in (("rows_step", "1603"), ("fused_step", "1425")):
            name = f"{form}[{key}]"
            if name not in times:
                continue
            e = kernel_entry(name, src, f"vmas_tpu/core/fused.py:{site}", n[form], errs[name], times[name],
                             *work[name])
            e["launches_on"] = (f"{key}'s main path at {NUM_ENVS} envs, "
                                + ("k_steps 1" if key != "asym_joint" else "rollout_fn"))
            if "other" in times[name]:
                e["other_lanes"], e["other_us"] = times[name]["other"][0], times[name]["other"][1] * 1e3
            entries.append(e)
    return entries


# -- the sensor worlds -----------------------------------------------------------------

# the sensor worlds' configs held to their plain versions: (make_env name,
# kwargs, whether the rows step takes it), and the counts each comparison
# must see above zero
SW_CONFIGS = {
    "navigation": ("navigation", {}, True),
    "flocking": ("flocking", {}, True),
    "discovery": ("discovery", {}, False),
    "discovery,penalty": ("discovery", {"shared_reward": True, "agent_collision_penalty": -1.0,
                                        "targets_respawn": False}, False),
}
SW_REQUIRED = {
    "navigation": ("on_goal", "hits", "done"), "flocking": ("hits",), "discovery": ("covered", "covering"),
    "discovery,penalty": ("covered", "covering", "hits"),
}
SW_CMP_STEPS = 5
SW_ROLLOUT_STEPS = 20
# the rollout_fn paths' horizon (discovery), and pollock's (its 45
# entities on the plain physics: ~0.2 s a step at 4096 envs)
SW_SHORT_HORIZON = 100
# the steps of the traced call of a host-bound rollout_fn path (discovery's two
# configs here, asym_joint, het_mass, simple_crypto): the profiler costs the
# host some 0.45 ms a device operation, and discovery takes ~480 a step
HOOK_TRACE_STEPS = 10
POLLOCK_HORIZON = 20


def sensor_ops(fo):
    """Operations of the sensor worlds' emits per env, besides writing their
    rows, read off csrc/fused_step.cu: 7 per distance, 2 per relative
    position; navigation's goal terms 13 per agent and 13 per colliding
    pair; flocking's 13 per pair of agents (the collision test and its
    terms) and 10 per (policy agent, other agent) deviation, 3 per agent;
    discovery's 9 per (agent, target) test, twice, 2 per agent and target,
    and with a penalty 11 per ordered pair of agents."""
    kind = type(fo).__name__
    A = fo.n_agents
    if kind == "NavigationOutputs":
        return 13 * A + 13 * len(fo.pairs) + (2 * A * A if fo.all_goals else 0) + 3
    if kind == "FlockingOutputs":
        n = len(fo.all_i)
        return 13 * n * (n - 1) // 2 + A * (10 * (n - 1) + 3 + 2) + 1
    T = fo.n_targets
    return 18 * A * T + 2 * (A + T) + 2 + (11 * A * (A - 1) + A if fo.coll_pen != 0 else 0)


def sensor_worlds_phase(card, dev):
    """navigation, flocking and discovery at 4096 envs: each emit's K1 (and
    navigation's and flocking's K2, with flocking's target on the action
    rows) bitwise its plain version over SW_CMP_STEPS re-synced steps from
    testing.sensor_state at one thread and at 8 lanes per env, with the
    events counted and required (agents on their goals, collision hits,
    covered targets, covering agents), and a 4-step launch bitwise 4
    launches of one; the Lidar's rays on the card against the same plain
    code on the CPU; navigation's rows rollout with its Lidar (each step's
    state rebuilt from its carry rows) at the main path's horizon,
    navigation without it at k_steps 1 and 4, flocking's rows rollout and
    navigation's HeuristicPolicy on the rows policy rollout, each bitwise
    its env.step rollout; discovery (both configs) and pollock (its
    vectorized Lidar against its per-ray loop) through rollout_fn; then the
    main paths with the counts zeroed (navigation and flocking on
    rows_rollout_fn at k_steps 1, horizon 1000, with the Lidar rebuild's
    share of a call; discovery on rollout_fn, 100 steps); the phase's
    entries of the kernels line."""
    import numpy as np
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.heuristic_policy import rollout_policy
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_policy_rollout_fn, rows_rollout_fn
    from vmas_tpu_torch.scenarios.navigation import HeuristicPolicy as NavigationPolicy

    R = sys.modules["vmas_tpu_torch.parallel.rollout"]
    times, work, errs = {}, {}, {}
    B = NUM_ENVS
    # -- (a) K2 and K1 against plain, bitwise, at both forms; k_steps ---------------
    for key, (name, kw, rows) in SW_CONFIGS.items():
        env = make_env(name, B, device=dev, seed=0, fused_physics=True, **kw)
        world, fo = env.world, env._fused_outputs
        slots = [a.index for a in env.agents] + list(getattr(fo, "script_slots", ()))
        ks = F._kernel_spec(world)
        E, A = ks.E, len(slots)
        assert rows == F.rows_step_supported(world, fo, env.agents)
        st = state_from_numpy(world, testing.sensor_state(env, np.random.default_rng(100)))
        carry0 = F.pack_carry(world, st, fo)
        x0 = torch.cat([F.state_rows(st), st.joint_fixed_rot.T, fo.scratch_rows(st)]).contiguous()
        step = F.make_rows_step(world, fo, slots) if rows else None
        gen = torch.Generator(device=dev).manual_seed(101)
        acts = lambda: (torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1).contiguous()
        counts = {}

        def count(d):
            for k, v in d.items():
                counts[k] = counts.get(k, 0) + v

        for lanes in (1, 8):
            k2, k1 = ErrTracker(), ErrTracker()
            carry, x = carry0, x0

            def run_steps():
                nonlocal carry, x
                for t in range(SW_CMP_STEPS):
                    act = acts()
                    if rows:
                        c_k, e_k = step(carry, act)
                        c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
                        compare_rows(k2, c_k, c_p, e_k, e_p, f"{key} rows_step L{lanes}")
                        count(testing.sensor_events(env, c_p[:9 * E], e_p))
                        carry = c_k
                    y_k, y_p = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
                    compare_rows(k1, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], f"{key} fused_step L{lanes}")
                    count(testing.sensor_events(env, y_p[:9 * E], y_p[9 * E:]))
                    x = with_actions(torch.cat([y_k[:9 * E], x[9 * E:]]), act, slots, E).contiguous()

            at_lanes(ks, lanes, run_steps)
            torch.cuda.synchronize()
            if lanes == ks.lanes:
                errs[f"fused_step[{key}]"] = k1.max()
                if rows:
                    errs[f"rows_step[{key}]"] = k2.max()
        shown = {k: v for k, v in counts.items() if v or k in SW_REQUIRED[key]}
        print(f"{key}@{B}: {'rows_step and ' if rows else ''}fused_step bitwise their plain versions over "
              f"{SW_CMP_STEPS} re-synced steps at 1 and at 8 lanes per env (the rule's {ks.lanes}; E {E}, pairs "
              f"{dict((t, len(getattr(ks, t))) for t in F.PAIR_TYPES if getattr(ks, t))}; events {shown}) on {card}",
              flush=True)
        missing = [k for k in SW_REQUIRED[key] if not counts.get(k)]
        if missing:
            raise AssertionError(f"the {key} comparison saw none of {missing}: {counts}")
        act = acts()
        carry = carry0
        x = with_actions(x0, act, slots, E).contiguous()
        if rows:
            act_k = torch.cat([acts() for _ in range(K_STEPS)]).contiguous()

            def compare(tr, k, c_k, c_p, e_k, e_p, mid, key=key):
                tr.close(f"{key} k{K_STEPS} step {k} emit rows", e_k, e_p)
                if k == K_STEPS - 1:
                    tr.close(f"{key} k{K_STEPS} carry", c_k, c_p)

            k_steps_check(world, fo, slots, carry, act_k, f"{key}@{B}", compare)
            extra = torch.empty((fo.n_out, B), device=dev)
            rkey = f"rows_step[{key}]"
            times[rkey] = kernel_times(rkey, lambda: step(carry, act, extra),
                                       lambda: F.rows_step_plain(world, fo, slots, carry, act), "fused_step_kernel")
            work[rkey] = ((2 * carry.shape[0] + 2 * A + fo.n_out) * B * 4,
                          kernel_ops(ks, carry, fo, rows_form=True))
        fkey = f"fused_step[{key}]"
        times[fkey] = kernel_times(fkey, lambda: F.fused_step(world, x, fo), lambda: F.fused_step_plain(world, x, fo),
                                   "fused_step_kernel")
        work[fkey] = ((x.shape[0] + 9 * E + fo.n_out) * B * 4, kernel_ops(ks, x, fo))
        other = 8 if ks.lanes == 1 else 1
        form = (f"rows_step[{key}]", lambda: step(carry, act, extra)) if rows else (fkey, lambda: F.fused_step(
            world, x, fo))
        other_ms = at_lanes(ks, other, lambda: launch_ms(form[1], 200, "fused_step_kernel", "the other form"))
        times[form[0]]["other"] = (other, other_ms)
        print(f"{form[0]} at {other} lane{'s' if other > 1 else ''} per env: {other_ms * 1e3:.3f} us on the device "
              f"(the rule's {ks.lanes}: {times[form[0]]['ms'] * 1e3:.3f} us)", flush=True)
        del env, carry, carry0, x, x0

    # -- (b) the Lidar's rays on the card against the plain code on the CPU ---------
    env = make_env("navigation", B, device=dev, seed=0)
    cpu = make_env("navigation", B, device="cpu", seed=0)
    st = state_from_numpy(env.world, testing.sensor_state(env, np.random.default_rng(102)))
    st_cpu = state_from_numpy(cpu.world, testing.sensor_state(env, np.random.default_rng(102)))
    worst, hits = 0.0, 0
    for a, a_cpu in zip(env.world.agents, cpu.world.agents):
        got, want = a.sensors[0].measure(st), a_cpu.sensors[0].measure(st_cpu)
        worst = max(worst, float((got.cpu() - want).abs().max()))
        hits += int((want < a.sensors[0].max_range).sum())
    print(f"navigation@{B} Lidar on the card vs the same plain code on the CPU: max abs err {worst:.3e} over "
          f"{hits} ray hits (atol 2e-5) on {card}", flush=True)
    if worst > 2e-5 or not hits:
        raise AssertionError(f"the Lidar on the card differs from the CPU's by {worst} ({hits} hits)")
    del env, cpu

    # -- (c) the rows rollouts against the env.step rollouts, bitwise --------------
    def bitwise(tag, run_a, run_b, s0, st0, seed):
        sa, _, ta = run_a(s0, st0, torch.Generator(device=dev).manual_seed(seed))
        sb, _, tb = run_b(s0, st0, torch.Generator(device=dev).manual_seed(seed))
        rollouts_bitwise(tag, ta, tb, sa, sb, card)

    env = make_env("navigation", B, device=dev, seed=0, fused_physics=True)
    s0 = state_from_numpy(env.world, testing.sensor_state(env, np.random.default_rng(103)))
    bitwise(f"navigation@{B} env.step rollout vs rows rollout (its Lidar on each step's rebuilt state) over "
            f"{HORIZON} steps", rollout_fn(env, horizon=HORIZON), rows_rollout_fn(env, horizon=HORIZON), s0,
            env.steps, 7)
    env = make_env("navigation", B, device=dev, seed=0, fused_physics=True, collisions=False)
    for k in (1, K_STEPS):
        bitwise(f"navigation,no_lidar@{B} env.step rollout vs rows rollout k_steps {k} over {SW_ROLLOUT_STEPS} steps",
                rollout_fn(env, horizon=SW_ROLLOUT_STEPS), rows_rollout_fn(env, horizon=SW_ROLLOUT_STEPS, k_steps=k),
                env.state, env.steps, 8)
    policy = rollout_policy(env, NavigationPolicy(True))
    bitwise(f"navigation,no_lidar@{B} env.step policy rollout vs rows policy rollout (its HeuristicPolicy) over "
            f"{SW_ROLLOUT_STEPS} steps", rollout_fn(env, policy, SW_ROLLOUT_STEPS),
            rows_policy_rollout_fn(env, policy, SW_ROLLOUT_STEPS), env.state, env.steps, 9)
    env = make_env("flocking", B, device=dev, seed=0, fused_physics=True)
    s0 = state_from_numpy(env.world, testing.sensor_state(env, np.random.default_rng(104)))
    bitwise(f"flocking@{B} env.step rollout vs rows rollout (the target's script on the action rows) over "
            f"{SW_ROLLOUT_STEPS} steps", rollout_fn(env, horizon=SW_ROLLOUT_STEPS),
            rows_rollout_fn(env, horizon=SW_ROLLOUT_STEPS), s0, env.steps, 10)
    del env

    # -- (d) pollock through rollout_fn: its vectorized Lidar against the loop ---
    F.fused_step_launches = 0
    F.rows_step_launches = 0
    env = make_env("pollock", B, device=dev, seed=0, fused_physics=True, lidar=True)
    assert env._fused_outputs is None and not F.supports(env.world)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, steps, traj = rollout_fn(env, horizon=POLLOCK_HORIZON)(env.state, env.steps,
                                                                  torch.Generator(device=dev).manual_seed(0))
    end.record()
    end.synchronize()
    call_ms = [start.elapsed_time(end)]
    n = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
    assert n == {"fused_step": 0, "rows_step": 0}, n
    assert all(bool(torch.isfinite(o).all()) for o in traj["obs"])
    worst, hits = 0.0, 0
    for a in env.world.agents:
        v, loop = a.sensors[0].measure(state), a.sensors[0].measure(state, vectorized=False)
        worst = max(worst, float((v - loop).abs().max()))
        hits += int((v < a.sensors[0].max_range).sum())
    print(f"pollock@{B} ({len(env.world.entities)} entities, the plain physics: supports() refuses it) through "
          f"rollout_fn, {POLLOCK_HORIZON} steps: {call_ms[0]:.3f} ms a call; its vectorized Lidar vs its per-ray "
          f"loop: max abs err {worst:.3e} over {hits} ray hits (atol 1e-5); launches {n} on {card}", flush=True)
    if worst > 1e-5 or not hits:
        raise AssertionError(f"pollock's vectorized Lidar differs from its loop by {worst} ({hits} hits)")
    del env, state, traj

    # -- (e) the main paths ------------------------------------------------------
    launches = {}
    runs = [("navigation", "navigation", {}, "rows"), ("flocking", "flocking", {}, "rows"),
            ("discovery", "discovery", {}, "step"),
            ("discovery,penalty", "discovery", SW_CONFIGS["discovery,penalty"][1], "step")]
    for key, name, kw, path in runs:
        horizon = HORIZON if path == "rows" else SW_SHORT_HORIZON
        F.fused_step_launches = 0
        F.rows_step_launches = 0
        env = make_env(name, num_envs=B, fused_physics=True, **kw)
        assert env.device.type == "cuda"
        obs = env.reset()
        for _ in range(5):
            obs, rews, dones, infos = env.step(env.get_random_actions())
        rgen = torch.Generator(device=dev).manual_seed(0)
        run = rows_rollout_fn(env, horizon=horizon) if path == "rows" else rollout_fn(env, horizon=horizon)
        state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
        n = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
        want = ({"fused_step": 5, "rows_step": horizon * (1 + TIMED_CALLS)} if path == "rows" else
                {"fused_step": 5 + horizon * (1 + TIMED_CALLS), "rows_step": 0})
        assert n == want, (key, n, want)
        widths = [o.shape[-1] for o in obs]
        assert traj["rewards"].shape == (horizon, B, env.n_agents) and bool(torch.isfinite(traj["rewards"]).all())
        assert all(o.shape == (horizon, B, w) and bool(torch.isfinite(o).all()) for o, w in zip(traj["obs"], widths))
        assert bool(torch.isfinite(state.pos).all())
        tag = "rows_rollout_fn k_steps 1" if path == "rows" else "rollout_fn (env.step: K1)"
        print(f"main path: {key} {B} envs x {env.n_agents} agents x {horizon} steps, {tag}; launches {n}", flush=True)
        rollout_report(f"{key}@{B} {tag}", run, state, steps, rgen, call_ms, warm_s, B, card, horizon=horizon,
                       trace=None if path == "rows" else (rollout_fn(env, horizon=HOOK_TRACE_STEPS), HOOK_TRACE_STEPS))
        if path == "rows":
            # the Lidar rebuild's share of one more call: the unpack over the
            # rebuilt states, timed with CUDA events around it
            spent = []
            inner = R._unpack_over_states

            def timed_unpack(*a, **k):
                s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s_.record()
                out = inner(*a, **k)
                e_.record()
                spent.append((s_, e_))
                return out

            R._unpack_over_states = timed_unpack
            try:
                # a warm-up call, then the timed one, whose rebuild is the last
                call = timed_rollout(run, state, steps, rgen, calls=1)[3][0]
            finally:
                R._unpack_over_states = inner
            rebuild = spent[-1][0].elapsed_time(spent[-1][1])
            print(f"{key}@{B} rows_rollout_fn: the state rebuild and unpack (the Lidar over {horizon} x {B} "
                  f"env-steps, chunks of {R._STATE_CHUNK // B} steps) {rebuild:.3f} ms of a {call:.3f} ms call "
                  f"(share {rebuild / call:.3f}) on {card}", flush=True)
        launches[key] = n
        del env, state, traj

    entries = []
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    for key in SW_CONFIGS:
        n = launches[key]
        for form, site in (("rows_step", "1603"), ("fused_step", "1425")):
            name = f"{form}[{key}]"
            if name not in times:
                continue
            e = kernel_entry(name, src, f"vmas_tpu/core/fused.py:{site}", n[form], errs[name], times[name],
                             *work[name])
            e["launches_on"] = (f"{key}'s main path at {NUM_ENVS} envs, "
                                + ("rows_rollout_fn k_steps 1" if SW_CONFIGS[key][2] else "rollout_fn"))
            if "other" in times[name]:
                e["other_lanes"], e["other_us"] = times[name]["other"][0], times[name]["other"][1] * 1e3
            entries.append(e)
    return entries


# -- football ---------------------------------------------------------------------

# football's configs held to their plain versions: (make_env kwargs, whether
# the rows step takes it), and the counts each comparison must see above zero
FB_CONFIGS = {
    "football": ({}, False),
    "football,two_teams": ({"ai_red_agents": False}, True),
}
FB_REQUIRED = ("blue_scores", "red_scores", "agent_shaping", "ls")
FB_ROWS_REQUIRED = ("impulse", "x_zeroed")
FB_CMP_STEPS = 5
FB_ROLLOUT_STEPS = 20
# the rollout_fn paths' horizon (the hooks around K1 each step): both teams
# at the VMAS protocol's 100 (the rows path's ratio to it); the red AI's and
# the shooting config's, 600-1200 device operations a step on the host, at
# 50 with one timed call
FB_SHORT_HORIZON = 100
FB_HOOK_HORIZON = 50
# the steps of the hook configs' traced call (rollout_report): the profiler
# costs the host ~0.45 ms a device operation
FB_TRACE_STEPS = 10
# the ball's script per env, read off ball_act: 4 walls of a subtraction,
# a minimum, a division and a subtraction, the vertical factor 4, the two
# impulses 3 each, the goal-mouth test 3 and its select
BALL_OPS = 30


def football_ops(fo):
    """Operations of football's emit per env, besides writing its rows, read
    off csrc/fused_step.cu: the score's tests and terms 10; per dense team
    the goal distance 8, its terms 2, 8 per team agent's distance and its
    minimum, the agent terms 11; per policy agent 12 differences and
    negations of its own rows and 6 per observed other agent."""
    teams = int(fo.dense_blue) * len(fo.blue_i) + int(fo.dense_red) * len(fo.red_i)
    dense = (int(fo.dense_blue) + int(fo.dense_red)) * 21 + 8 * teams
    return 10 + dense + sum(12 + 6 * (w - 16) // 8 for w in fo.widths)


def football_phase(card, dev):
    """Football at 4096 envs: its emit's K1 (the red AI's config and both
    teams') and, for both teams, its K2 with the ball's script in the
    kernel, bitwise their plain versions over FB_CMP_STEPS re-synced steps
    from testing.football_state at one thread and at 8 lanes per env, with
    the events counted and required (each team's goals, live agent
    shaping, line-sphere contacts; in K2 non-zero impulses and x impulses
    zeroed in the goal mouth), and a 4-step launch bitwise 4 launches of
    one; the shooting config's K1 with no emit against its plain version;
    both teams' rows rollouts (k_steps 1 and 4) and rows policy rollout
    bitwise rollout_fn; then the main paths with the counts zeroed; the
    phase's entries of the kernels line."""
    import numpy as np
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_policy_rollout_fn, rows_rollout_fn

    times, work, errs = {}, {}, {}
    B = NUM_ENVS
    t_phase = time.perf_counter()
    # -- (a) K2 and K1 against plain, bitwise, at both forms; k_steps ---------------
    for key, (kw, rows) in FB_CONFIGS.items():
        env = make_env("football", B, device=dev, seed=0, fused_physics=True, **kw)
        world, fo = env.world, env._fused_outputs
        slots = [a.index for a in env.agents]
        ks = F._kernel_spec(world)
        E, A = ks.E, len(slots)
        assert rows == F.rows_step_supported(world, fo, env.agents)
        st = state_from_numpy(world, testing.football_state(env, np.random.default_rng(110)))
        carry0 = F.pack_carry(world, st, fo)
        x0 = torch.cat([F.state_rows(st), st.joint_fixed_rot.T, fo.scratch_rows(st)]).contiguous()
        step = F.make_rows_step(world, fo, slots) if rows else None
        gen = torch.Generator(device=dev).manual_seed(111)
        acts = lambda: (torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1).contiguous()
        counts = {}

        def count(d):
            for k, v in d.items():
                counts[k] = counts.get(k, 0) + v

        for lanes in (1, 8):
            k2, k1 = ErrTracker(), ErrTracker()
            carry, x = carry0, x0

            def run_steps():
                nonlocal carry, x
                for t in range(FB_CMP_STEPS):
                    act = acts()
                    if rows:
                        c_k, e_k = step(carry, act)
                        c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
                        compare_rows(k2, c_k, c_p, e_k, e_p, f"{key} rows_step L{lanes}")
                        count(testing.football_events(env, carry, e_p[:fo.n_out], e_p[fo.n_out:]))
                        carry = c_k
                    y_k, y_p = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
                    compare_rows(k1, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], f"{key} fused_step L{lanes}")
                    count(testing.football_events(env, x, y_p[9 * E:]))
                    x = with_actions(torch.cat([y_k[:9 * E], x[9 * E:]]), act, slots, E).contiguous()

            at_lanes(ks, lanes, run_steps)
            torch.cuda.synchronize()
            if lanes == ks.lanes:
                errs[f"fused_step[{key}]"] = k1.max()
                if rows:
                    errs[f"rows_step[{key}]"] = k2.max()
        print(f"{key}@{B}: {'rows_step (the ball script in the kernel) and ' if rows else ''}fused_step bitwise "
              f"their plain versions over {FB_CMP_STEPS} re-synced steps at 1 and at 8 lanes per env (the rule's "
              f"{ks.lanes}; E {E}, pairs {dict((t, len(getattr(ks, t))) for t in F.PAIR_TYPES if getattr(ks, t))}, "
              f"emit rows {fo.n_out}; events {counts}) on {card}", flush=True)
        missing = [k for k in FB_REQUIRED + (FB_ROWS_REQUIRED if rows else ()) if not counts.get(k)]
        if missing:
            raise AssertionError(f"the {key} comparison saw none of {missing}: {counts}")
        act = acts()
        carry = carry0
        x = with_actions(x0, act, slots, E).contiguous()
        if rows:
            act_k = torch.cat([acts() for _ in range(K_STEPS)]).contiguous()

            def compare(tr, k, c_k, c_p, e_k, e_p, mid, key=key):
                tr.close(f"{key} k{K_STEPS} step {k} emit and hook rows", e_k, e_p)
                if k == K_STEPS - 1:
                    tr.close(f"{key} k{K_STEPS} carry", c_k, c_p)

            k_steps_check(world, fo, slots, carry, act_k, f"{key}@{B}", compare)
            n_tot = fo.n_out + fo.n_ctrl_out
            extra = torch.empty((n_tot, B), device=dev)
            rkey = f"rows_step[{key}]"
            times[rkey] = kernel_times(rkey, lambda: step(carry, act, extra),
                                       lambda: F.rows_step_plain(world, fo, slots, carry, act), "fused_step_kernel")
            work[rkey] = ((2 * carry.shape[0] + 2 * A + n_tot) * B * 4, kernel_ops(ks, carry, fo, rows_form=True))
        fkey = f"fused_step[{key}]"
        times[fkey] = kernel_times(fkey, lambda: F.fused_step(world, x, fo), lambda: F.fused_step_plain(world, x, fo),
                                   "fused_step_kernel")
        work[fkey] = ((x.shape[0] + 9 * E + fo.n_out) * B * 4, kernel_ops(ks, x, fo))
        other = 8 if ks.lanes == 1 else 1
        for name, fn in ([(f"rows_step[{key}]", lambda: step(carry, act, extra))] if rows else []) + [
                (fkey, lambda: F.fused_step(world, x, fo))]:
            other_ms = at_lanes(ks, other, lambda: launch_ms(fn, 200, "fused_step_kernel", "the other form"))
            times[name]["other"] = (other, other_ms)
            print(f"{name} at {other} lane{'s' if other > 1 else ''} per env: {other_ms * 1e3:.3f} us on the device "
                  f"(the rule's {ks.lanes}: {times[name]['ms'] * 1e3:.3f} us)", flush=True)
        del env, carry, carry0, x, x0

    # the shooting config: K1 with no emit (the hook pipeline around it), its
    # agents' torque rows from HolonomicWithRotation, on the rows of env.step
    # calls
    skey = "fused_step[football,shooting]"
    env = make_env("football", B, device=dev, seed=0, fused_physics=True, enable_shooting=True, ai_red_agents=False)
    world = env.world
    ks = F._kernel_spec(world)
    E = ks.E
    assert env._fused_outputs is None and world.fused
    k1 = ErrTracker()
    torque_lanes = 0
    for t in range(FB_CMP_STEPS):
        env.step(env.get_random_actions())
        x = torch.cat([F.state_rows(env.state), env.state.joint_fixed_rot.T]).contiguous()
        torque_lanes += int((x[8 * E:9 * E] != 0).sum())
        k1.close("football,shooting fused_step state rows", F.fused_step(world, x), F.fused_step_plain(world, x))
    print(f"football,shooting@{B}: fused_step (no emit) bitwise its plain version on the rows of {FB_CMP_STEPS} "
          f"env.step calls at {ks.lanes} lanes per env (torque rows set in {torque_lanes} (env, agent) lanes) on "
          f"{card}", flush=True)
    if not torque_lanes:
        raise AssertionError("the football shooting comparison saw no torque")
    errs[skey] = k1.max()
    other_form_bitwise(ks, [(lambda: F.fused_step(world, x), lambda: F.fused_step_plain(world, x))],
                       f"football,shooting@{B}")
    times[skey] = kernel_times(skey, lambda: F.fused_step(world, x), lambda: F.fused_step_plain(world, x),
                               "fused_step_kernel")
    work[skey] = ((x.shape[0] + 9 * E) * B * 4, kernel_ops(ks, x))
    del env

    # -- (b) the rows rollouts against the env.step rollouts, bitwise --------------
    print(f"football: the kernels against plain, {time.perf_counter() - t_phase:.1f} s", flush=True)

    def bitwise(tag, run_a, run_b, s0, st0, seed):
        sa, _, ta = run_a(s0, st0, torch.Generator(device=dev).manual_seed(seed))
        sb, _, tb = run_b(s0, st0, torch.Generator(device=dev).manual_seed(seed))
        rollouts_bitwise(tag, ta, tb, sa, sb, card)

    env = make_env("football", B, device=dev, seed=0, fused_physics=True, ai_red_agents=False)
    s0 = state_from_numpy(env.world, testing.football_state(env, np.random.default_rng(112)))
    for k in (1, K_STEPS):
        bitwise(f"football,two_teams@{B} env.step rollout vs rows rollout k_steps {k} (the ball script in the kernel, "
                f"the red mirror a decode transform) over {FB_ROLLOUT_STEPS} steps",
                rollout_fn(env, horizon=FB_ROLLOUT_STEPS), rows_rollout_fn(env, horizon=FB_ROLLOUT_STEPS, k_steps=k),
                s0, env.steps, 20 + k)
    W = (torch.rand((56, 2), generator=torch.Generator(device=dev).manual_seed(5), device=dev) * 2 - 1) * 0.5
    policy = lambda obs, g: tuple(torch.tanh(o @ W) for o in obs)
    bitwise(f"football,two_teams@{B} env.step policy rollout vs rows policy rollout (a linear policy) over "
            f"{FB_ROLLOUT_STEPS} steps", rollout_fn(env, policy, FB_ROLLOUT_STEPS),
            rows_policy_rollout_fn(env, policy, FB_ROLLOUT_STEPS), s0, env.steps, 23)
    del env

    # -- (c) the main paths ------------------------------------------------------
    print(f"football: the rollouts bitwise, {time.perf_counter() - t_phase:.1f} s", flush=True)
    launches, rates = {}, {}
    runs = [("football,two_teams", {"ai_red_agents": False}, "rows", 1),
            ("football,two_teams", {"ai_red_agents": False}, "rows", K_STEPS),
            ("football,two_teams", {"ai_red_agents": False}, "step", 1),
            ("football", {}, "step", 1),
            ("football,shooting", {"enable_shooting": True, "ai_red_agents": False}, "step", 1)]
    for key, kw, path, k in runs:
        hooks = key != "football,two_teams"
        horizon = HORIZON if path == "rows" else FB_HOOK_HORIZON if hooks else FB_SHORT_HORIZON
        calls = 1 if hooks else TIMED_CALLS
        F.fused_step_launches = 0
        F.rows_step_launches = 0
        env = make_env("football", num_envs=B, fused_physics=True, **kw)
        assert env.device.type == "cuda"
        obs = env.reset()
        for _ in range(5):
            obs, rews, dones, infos = env.step(env.get_random_actions())
        rgen = torch.Generator(device=dev).manual_seed(0)
        run = rows_rollout_fn(env, horizon=horizon, k_steps=k) if path == "rows" else rollout_fn(env, horizon=horizon)
        torch.cuda.reset_peak_memory_stats()
        state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen, calls=calls)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
        want = ({"fused_step": 5, "rows_step": horizon // k * (1 + calls)} if path == "rows" else
                {"fused_step": 5 + horizon * (1 + calls), "rows_step": 0})
        assert n == want, (key, n, want)
        widths = [o.shape[-1] for o in obs]
        assert traj["rewards"].shape == (horizon, B, env.n_agents) and bool(torch.isfinite(traj["rewards"]).all())
        assert all(o.shape == (horizon, B, w) and bool(torch.isfinite(o).all()) for o, w in zip(traj["obs"], widths))
        assert bool(torch.isfinite(state.pos).all())
        tag = (f"rows_rollout_fn k_steps {k}" if path == "rows" else
               "rollout_fn (env.step: K1" + (", the red AI in torch)" if key == "football" else ")"))
        print(f"main path: {key} {B} envs x {env.n_agents} agents x {horizon} steps, {tag}; launches {n}; peak "
              f"device memory {peak_gb:.2f} GB ({time.perf_counter() - t_phase:.1f} s into the phase)", flush=True)
        trace = (rollout_fn(env, horizon=FB_TRACE_STEPS), FB_TRACE_STEPS) if hooks else None
        rates[(key, path, k)] = rollout_report(f"{key}@{B} {tag}", run, state, steps, rgen, call_ms, warm_s, B, card,
                                               horizon=horizon, trace=trace)[0]
        if path == "rows" and k == 1:
            launches[(key, "rows_step")] = n["rows_step"]
        if path == "step":
            launches[(key, "fused_step")] = n["fused_step"]
        del env, state, traj
    ratio = rates[("football,two_teams", "rows", 1)] / rates[("football,two_teams", "step", 1)]
    print(f"football,two_teams@{B}: the rows path (k_steps 1) at {ratio:.2f}x rollout_fn's env-steps/s on {card} "
          f"(the JAX package's TPU measure of the same ratio, in its own terms: 0.91x)", flush=True)

    entries = []
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    for name in times:
        key = name[name.index("[") + 1:-1]
        form = name[:name.index("[")]
        n = launches[(key, form)]
        e = kernel_entry(name, src, f"vmas_tpu/core/fused.py:{'1603' if form == 'rows_step' else '1425'}", n,
                         errs[name], times[name], *work[name])
        e["launches_on"] = (f"{key}'s main path at {NUM_ENVS} envs, "
                            + ("rows_rollout_fn k_steps 1" if form == "rows_step" else "rollout_fn"))
        if "other" in times[name]:
            e["other_lanes"], e["other_us"] = times[name]["other"][0], times[name]["other"][1] * 1e3
        entries.append(e)
    return entries


# -- the dynamics and controller debug worlds ------------------------------------

# the seven worlds (vmas_tpu_torch.testing.DEBUG_WORLDS, each at its
# defaults), the events each K1 comparison must see above zero: box-box
# contacts, torque rows set, forces beyond an agent's f_range (the
# controllers asked for more, and the kernel clamps them)
DW_REQUIRED = {
    "diff_drive": ("torque",), "kinematic_bicycle": ("bb",), "drone": ("torque",),
    "goal": ("clamped",), "vel_control": ("clamped",), "circle_trajectory": ("clamped",),
    "line_trajectory": ("clamped",),
}
DW_CMP_STEPS = 5
DW_HORIZON = 100
# the steps of the main path's traced call (rollout_report), and the plain
# version's timed calls (kinematic_bicycle's takes 0.9 s a call)
DW_TRACE_STEPS = 10
DW_PLAIN_CALLS = 5
# steps of the grouped-against-loop rollouts (transport and football's two
# teams, then road_traffic), and the process_action phase's timed calls
DW_GROUP_STEPS = 20
DW_RT_GROUP_STEPS = 5
DW_ACT_CALLS = 20


def _with_batch_dynamics(flag, build):
    """``build()`` with ``VMAS_TPU_BATCH_DYNAMICS`` set to ``flag`` (unset
    for None), which an Environment reads when it is built."""
    import os

    old = os.environ.pop("VMAS_TPU_BATCH_DYNAMICS", None)
    if flag is not None:
        os.environ["VMAS_TPU_BATCH_DYNAMICS"] = flag
    try:
        return build()
    finally:
        os.environ.pop("VMAS_TPU_BATCH_DYNAMICS", None)
        if old is not None:
            os.environ["VMAS_TPU_BATCH_DYNAMICS"] = old


def debug_worlds_phase(card, dev):
    """The dynamics and controller debug worlds at 4096 envs (diff_drive,
    kinematic_bicycle, drone, goal, vel_control, circle_trajectory,
    line_trajectory): each world's K1 with no emit against its plain
    version, bitwise, at one thread and at 8 lanes per env, over
    DW_CMP_STEPS steps from testing.debug_world_state, each step's input
    rows those of the step's hooks (process_action: the dynamics models, the
    controllers) and the env re-synced to the kernel's step, with the events
    counted and required (DW_REQUIRED); each world's main path with the
    count zeroed (rollout_fn, DW_HORIZON steps, 3 timed calls: env-steps/s,
    idle share, device operations a step; the drone's u at its spawn
    width); then the grouped process_action against the per-agent loop on
    the card: transport's four holonomic agents and football's two teams
    with the default grouping, bitwise over DW_GROUP_STEPS steps, and
    road_traffic's 20 kinematic bicycles with VMAS_TPU_BATCH_DYNAMICS=1
    over DW_RT_GROUP_STEPS steps (whether bitwise, the largest difference,
    the process_action phase's ms against the loop's); the phase's entries
    of the kernels line."""
    import numpy as np
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rollout_fn

    B = NUM_ENVS
    t_phase = time.perf_counter()
    times, work, errs, launches = {}, {}, {}, {}
    for name in testing.DEBUG_WORLDS:
        key = f"fused_step[{name}]"
        env = make_env(name, B, device=dev, seed=0, fused_physics=True)
        world = env.world
        assert env._fused_outputs is None and world.fused and F.supports(world)
        ks = F._kernel_spec(world)
        E, n = ks.E, env.n_agents
        s0 = state_from_numpy(world, testing.debug_world_state(env, np.random.default_rng(120)))
        counts = {}
        k1 = ErrTracker()

        def run_steps():
            nonlocal x
            env.state = s0
            for t in range(DW_CMP_STEPS):
                acts = [torch.as_tensor(a, device=dev)
                        for a in testing.debug_world_actions(env, np.random.default_rng(121 + t))]
                st = env._act(env.state, acts, [(None, None)] * n)
                x = torch.cat([F.state_rows(st), st.joint_fixed_rot.T]).contiguous()
                for k, v in testing.debug_world_events(env, x).items():
                    counts[k] = counts.get(k, 0) + v
                k1.close(f"{name} fused_step state rows at {ks.lanes} lane(s)", F.fused_step(world, x),
                         F.fused_step_plain(world, x))
                env.step(acts)  # the next step from the kernel's

        x = None
        for lanes in (1, 8):
            at_lanes(ks, lanes, run_steps)
        print(f"{name}@{B}: fused_step (no emit) bitwise its plain version over {DW_CMP_STEPS} re-synced steps at "
              f"1 and 8 lanes per env (the rule picks {ks.lanes}; E {E}, substeps {ks.substeps}); events over both "
              f"runs {counts} on {card}", flush=True)
        missing = [k for k in DW_REQUIRED[name] if not counts.get(k)]
        if missing:
            raise AssertionError(f"the {name} comparison saw no {missing}: {counts}")
        errs[key] = k1.max()
        times[key] = kernel_times(key, lambda: F.fused_step(world, x), lambda: F.fused_step_plain(world, x),
                                  "fused_step_kernel", plain_calls=DW_PLAIN_CALLS)
        work[key] = ((x.shape[0] + 9 * E) * B * 4, kernel_ops(ks, x))
        other = 8 if ks.lanes == 1 else 1
        other_ms = at_lanes(ks, other, lambda: launch_ms(lambda: F.fused_step(world, x), 200, "fused_step_kernel",
                                                         "the other form"))
        times[key]["other"] = (other, other_ms)
        print(f"{key} at {other} lane{'s' if other > 1 else ''} per env: {other_ms * 1e3:.3f} us on the device (the "
              f"rule's {ks.lanes}: {times[key]['ms'] * 1e3:.3f} us)", flush=True)
        del env, s0, x

        # the main path: env.step through rollout_fn, K1 with no emit a step
        F.fused_step_launches = 0
        env = make_env(name, num_envs=B, fused_physics=True)
        assert env.device.type == "cuda"
        obs = env.reset()
        for _ in range(5):
            obs, rews, dones, infos = env.step(env.get_random_actions())
        run = rollout_fn(env, horizon=DW_HORIZON)
        rgen = torch.Generator(device=dev).manual_seed(0)
        state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
        launches[key] = F.fused_step_launches
        assert launches[key] == 5 + DW_HORIZON * (1 + TIMED_CALLS), (key, launches[key])
        widths = [o.shape[-1] for o in obs]
        assert traj["rewards"].shape == (DW_HORIZON, B, n) and bool(torch.isfinite(traj["rewards"]).all())
        assert all(o.shape == (DW_HORIZON, B, w) and bool(torch.isfinite(o).all())
                   for o, w in zip(traj["obs"], widths))
        assert bool(torch.isfinite(state.pos).all())
        u_shapes = [tuple(u.shape) for u in state.u]
        assert u_shapes == [(B, a.action_size) for a in env.world.agents], u_shapes
        print(f"main path: {name} {B} envs x {n} agents x {DW_HORIZON} steps, rollout_fn (env.step: K1 with no "
              f"emit); launches {{'fused_step': {launches[key]}}}; u after the rollout {u_shapes} "
              f"({time.perf_counter() - t_phase:.1f} s into the phase)", flush=True)
        rollout_report(f"{name}@{B} rollout_fn", run, state, steps, rgen, call_ms, warm_s, B, card,
                       horizon=DW_HORIZON, trace=(rollout_fn(env, horizon=DW_TRACE_STEPS), DW_TRACE_STEPS))
        del env, state, traj

    # -- the grouped process_action against the per-agent loop on the card ----------
    for tag, name, kw in (("transport", "transport", {"n_agents": N_AGENTS}),
                          ("football,two_teams", "football", {"ai_red_agents": False})):
        grouped = _with_batch_dynamics(None, lambda: make_env(name, B, device=dev, seed=0, fused_physics=True, **kw))
        loop = _with_batch_dynamics("0", lambda: make_env(name, B, device=dev, seed=0, fused_physics=True, **kw))
        groups = [len(g) for g in grouped._pa_groups]
        assert loop._pa_groups == [] and groups == ([N_AGENTS] if name == "transport" else []), groups
        sa, _, ta = rollout_fn(grouped, horizon=DW_GROUP_STEPS)(grouped.state, grouped.steps,
                                                                 torch.Generator(device=dev).manual_seed(9))
        sb, _, tb = rollout_fn(loop, horizon=DW_GROUP_STEPS)(loop.state, loop.steps,
                                                              torch.Generator(device=dev).manual_seed(9))
        rollouts_bitwise(f"{tag}@{B} grouped process_action (groups {groups}) vs the per-agent loop over "
                         f"{DW_GROUP_STEPS} steps", ta, tb, sa, sb, card)
        del grouped, loop

    envs = {flag: _with_batch_dynamics(flag, lambda: make_env("road_traffic", B, device=dev, seed=0))
            for flag in ("0", "1")}
    assert envs["0"]._pa_groups == [] and [len(g) for g in envs["1"]._pa_groups] == [RT_AGENTS]
    out = {}
    for flag, env in envs.items():
        out[flag] = rollout_fn(env, horizon=DW_RT_GROUP_STEPS)(env.state, env.steps,
                                                               torch.Generator(device=dev).manual_seed(10))
    (sa, _, ta), (sb, _, tb) = out["0"], out["1"]
    pairs = [ta["rewards"], *ta["obs"], sa.pos, sa.vel, sa.rot, sa.ang_vel], [tb["rewards"], *tb["obs"], sb.pos,
                                                                               sb.vel, sb.rot, sb.ang_vel]
    same = all(torch.equal(a, b) for a, b in zip(*pairs)) and torch.equal(ta["dones"], tb["dones"])
    err = max(float((a - b).abs().max()) for a, b in zip(*pairs))
    if not math.isfinite(err) or err > 1e-2:
        raise AssertionError(f"road_traffic's grouped kinematic bicycles depart from the loop by {err:.3e}")
    # the process_action phase's time (decode, process_action, pre_step) of
    # each plan on one state, in turns: loop, grouped, grouped, loop
    acts = envs["0"].get_random_actions()
    act_ms = {"0": [], "1": []}
    for flag in ("0", "1", "1", "0"):
        env = envs[flag]
        act_ms[flag].append(time_ms(lambda: env._act(sa, acts, [(None, None)] * RT_AGENTS), DW_ACT_CALLS))
    loop_ms, group_ms = min(act_ms["0"]), min(act_ms["1"])
    print(f"road_traffic@{B} x {RT_AGENTS}, VMAS_TPU_BATCH_DYNAMICS=1 (one group of {RT_AGENTS} kinematic bicycles) "
          f"vs 0 (the per-agent loop) over {DW_RT_GROUP_STEPS} steps: bitwise equal {same}, max abs err {err:.3e}; "
          f"the process_action phase {group_ms:.3f} ms a step grouped against {loop_ms:.3f} ms in the loop "
          f"(best of 2, {DW_ACT_CALLS} calls each; turns {[[round(v, 3) for v in act_ms[f]] for f in ('0', '1')]}) "
          f"on {card}", flush=True)
    del envs, out

    entries = []
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    for key in times:
        e = kernel_entry(key, src, "vmas_tpu/core/fused.py:1425", launches[key], errs[key], times[key], *work[key])
        e["launches_on"] = f"{key[len('fused_step['):-1]}'s main path at {NUM_ENVS} envs, rollout_fn"
        e["other_lanes"], e["other_us"] = times[key]["other"][0], times[key]["other"][1] * 1e3
        entries.append(e)
    return entries


# -- the DOTS and sampling worlds ----------------------------------------------------

# the worlds (vmas_tpu_torch.testing.DOTS_WORLDS, each at its defaults) and
# the events each K1 comparison must see above zero: sphere-sphere and
# box-sphere contacts (sampling's arena has no walls: its agents beyond the
# bound instead)
DOTS_REQUIRED = {"painting": ("ss", "bs"), "painting_full": ("ss", "bs"), "construction": ("ss", "bs"),
                 "sampling": ("ss", "beyond_bound")}
DOTS_CMP_STEPS = 5
DOTS_HORIZON = 100
DOTS_TRACE_STEPS = 5
DOTS_PLAIN_CALLS = 5


def dots_entry_name(key):
    return "fused_step[painting,full]" if key == "painting_full" else f"fused_step[{key}]"


def dots_worlds_phase(card, dev):
    """painting (nav and task_type "full"), construction and sampling at
    4096 envs (none has fused outputs): each world's K1 with no emit
    against its plain version, bitwise, at one thread and at 8 lanes per
    env, over DOTS_CMP_STEPS steps from testing.dots_world_state, each
    step's input rows those of the step's hooks (painting's knowledge
    mixing among them) and the env stepped on through the kernel, with the
    contacts counted and required (DOTS_REQUIRED); sampling's visited cells,
    samples and observations over those steps bitwise those of a twin env
    stepped through K1's plain version, and its visited cells and samples
    from the card's positions bitwise the CPU's; each world's main path
    with the count zeroed (rollout_fn, DOTS_HORIZON steps, 3 timed calls:
    env-steps/s, idle share, device operations a step of a traced call of
    DOTS_TRACE_STEPS steps); the phase's entries of the kernels line."""
    import numpy as np
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rollout_fn

    B = NUM_ENVS
    t_phase = time.perf_counter()
    times, work, errs, launches = {}, {}, {}, {}
    for key, (name, kw) in testing.DOTS_WORLDS.items():
        entry = dots_entry_name(key)
        env = make_env(name, B, device=dev, seed=0, fused_physics=True, **kw)
        world = env.world
        assert env._fused_outputs is None and world.fused and F.supports(world)
        ks = F._kernel_spec(world)
        E, n = ks.E, env.n_agents
        s0 = state_from_numpy(world, testing.dots_world_state(env, np.random.default_rng(140)))
        counts = {}
        k1 = ErrTracker()
        step_acts = [[torch.as_tensor(a, device=dev) for a in testing.dots_world_actions(
            env, np.random.default_rng(141 + t))] for t in range(DOTS_CMP_STEPS)]

        def run_steps():
            nonlocal x
            env.state = s0
            for acts in step_acts:
                st = env._act(env.state, acts, [(None, None)] * n)
                x = torch.cat([F.state_rows(st), st.joint_fixed_rot.T]).contiguous()
                for k, v in testing.dots_world_events(env, x).items():
                    counts[k] = counts.get(k, 0) + v
                k1.close(f"{key} fused_step state rows at {ks.lanes} lane(s)", F.fused_step(world, x),
                         F.fused_step_plain(world, x))
                env.step(acts)  # the next step from the kernel's

        x = None
        for lanes in (1, 8):
            at_lanes(ks, lanes, run_steps)
        print(f"{key}@{B}: fused_step (no emit) bitwise its plain version over {DOTS_CMP_STEPS} re-synced steps at "
              f"1 and 8 lanes per env (the rule picks {ks.lanes}; E {E}, substeps {ks.substeps}); events over both "
              f"runs {counts} on {card}", flush=True)
        missing = [k for k in DOTS_REQUIRED[key] if not counts.get(k)]
        if missing:
            raise AssertionError(f"the {key} comparison saw no {missing}: {counts}")
        if key == "sampling":
            sampling_bitwise(env, s0, step_acts, card)
        errs[entry] = k1.max()
        times[entry] = kernel_times(entry, lambda: F.fused_step(world, x), lambda: F.fused_step_plain(world, x),
                                    "fused_step_kernel", plain_calls=DOTS_PLAIN_CALLS)
        work[entry] = ((x.shape[0] + 9 * E) * B * 4, kernel_ops(ks, x))
        other = 8 if ks.lanes == 1 else 1
        other_ms = at_lanes(ks, other, lambda: launch_ms(lambda: F.fused_step(world, x), 200, "fused_step_kernel",
                                                         "the other form"))
        times[entry]["other"] = (other, other_ms)
        print(f"{entry} at {other} lane{'s' if other > 1 else ''} per env: {other_ms * 1e3:.3f} us on the device "
              f"(the rule's {ks.lanes}: {times[entry]['ms'] * 1e3:.3f} us)", flush=True)
        del env, s0, x

        # the main path: env.step through rollout_fn, K1 with no emit a step
        F.fused_step_launches = 0
        env = make_env(name, num_envs=B, fused_physics=True, **kw)
        assert env.device.type == "cuda"
        obs = env.reset()
        for _ in range(5):
            obs, rews, dones, infos = env.step(env.get_random_actions())
        run = rollout_fn(env, horizon=DOTS_HORIZON)
        rgen = torch.Generator(device=dev).manual_seed(0)
        state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
        launches[entry] = F.fused_step_launches
        assert launches[entry] == 5 + DOTS_HORIZON * (1 + TIMED_CALLS), (entry, launches[entry])
        widths = [o.shape[-1] for o in obs]
        assert traj["rewards"].shape == (DOTS_HORIZON, B, n) and bool(torch.isfinite(traj["rewards"]).all())
        assert all(o.shape == (DOTS_HORIZON, B, w) and bool(torch.isfinite(o).all())
                   for o, w in zip(traj["obs"], widths))
        assert bool(torch.isfinite(state.pos).all())
        print(f"main path: {key} {B} envs x {n} agents x {DOTS_HORIZON} steps, rollout_fn (env.step: K1 with no "
              f"emit); launches {{'fused_step': {launches[entry]}}} ({time.perf_counter() - t_phase:.1f} s into "
              f"the phase)", flush=True)
        rollout_report(f"{key}@{B} rollout_fn", run, state, steps, rgen, call_ms, warm_s, B, card,
                       horizon=DOTS_HORIZON, trace=(rollout_fn(env, horizon=DOTS_TRACE_STEPS), DOTS_TRACE_STEPS))
        del env, state, traj

    entries = []
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    for key in testing.DOTS_WORLDS:
        entry = dots_entry_name(key)
        e = kernel_entry(entry, src, "vmas_tpu/core/fused.py:1425", launches[entry], errs[entry], times[entry],
                         *work[entry])
        e["launches_on"] = f"{key}'s main path at {NUM_ENVS} envs, rollout_fn"
        e["other_lanes"], e["other_us"] = times[entry]["other"][0], times[entry]["other"][1] * 1e3
        entries.append(e)
    return entries


def sampling_bitwise(env, s0, step_acts, card):
    """sampling's visited cells, samples and observations over the steps
    from ``s0`` bitwise those of a twin env stepped through K1's plain
    version; then the visited cells and samples from the card's positions
    bitwise those of the same scenario code on the CPU (the cell index
    divides by the grid spacing as a tensor)."""
    import torch
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.core import fused as F

    twin = make_env("sampling", env.num_envs, device=env.device, seed=0, fused_physics=True)
    kernel = F.fused_step
    runs = []
    for e, step_fn in ((env, kernel), (twin, lambda world, x, outputs=None: F.fused_step_plain(world, x, outputs))):
        F.fused_step = step_fn
        try:
            e.state = s0
            outs = [e.step(acts) for acts in step_acts]
        finally:
            F.fused_step = kernel
        runs.append((e.state, outs))
    (sa, oa), (sb, ob) = runs
    for t, (a, b) in enumerate(zip(oa, ob)):
        for ga, gb in zip([*a[0], *a[1]], [*b[0], *b[1]]):
            if not torch.equal(ga, gb):
                raise AssertionError(f"sampling's observations or rewards through K1 differ from the plain "
                                     f"version's at step {t}")
    if not torch.equal(sa.scenario["sampled"], sb.scenario["sampled"]):
        raise AssertionError("sampling's visited cells through K1 differ from the plain version's")
    cpu = make_env("sampling", env.num_envs, device="cpu", seed=0)
    scr = {k: v.cpu() for k, v in sa.scenario.items()}
    scr_dev = sa.scenario
    for a, ac in zip(env.world.agents, cpu.world.agents):
        v, scr_dev = env.scenario._sample(scr_dev, a.pos(sa), update_sampled_flag=True)
        vc, scr = cpu.scenario._sample(scr, a.pos(sa).cpu(), update_sampled_flag=True)
        if not (torch.equal(v.cpu(), vc) and torch.equal(scr_dev["sampled"].cpu(), scr["sampled"])):
            raise AssertionError("sampling's samples or visited cells on the card differ from the CPU's")
    n_cells = int(scr["sampled"].sum())
    print(f"sampling@{env.num_envs}: observations, rewards and visited cells over {len(step_acts)} steps through K1 "
          f"bitwise those through its plain version; samples and visited cells ({n_cells} cells) from the card's "
          f"positions bitwise the CPU's on {card}", flush=True)


def caps_phase(card, dev):
    """The worlds beyond the old caps (32 entities, 16 agents in an emit):
    simple_spread with 30 agents (60 entities, one thread per env: a block
    of 8 lanes would not hold its 3661 emit rows) through K2 and K1, and
    balance with 17 agents and simple_tag with 6 good agents and 12
    adversaries through their emits, each bitwise its plain version over
    CAPS_CMP_STEPS re-synced steps at 4096 envs, then timed; each world's
    main path (5 env.step calls and rows_rollout_fn, CAPS_HORIZON steps,
    k_steps 1); the caps and the kernel's by-value parameters; the phase's entries
    of the kernels line."""
    import ctypes

    import numpy as np
    import torch
    from vmas_tpu_torch import _kernels, make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.interop import state_from_numpy
    from vmas_tpu_torch.parallel.rollout import rows_rollout_fn

    B = NUM_ENVS
    entries = []
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    by_value = ctypes.sizeof(_kernels.FusedSpec) + ctypes.sizeof(_kernels.EmitParams) + ctypes.sizeof(
        _kernels.ActParams)
    print(f"caps: MAX_E {_kernels.MAX_E}, MAX_A {_kernels.MAX_A}, MAX_K {_kernels.MAX_K}; by-value parameters "
          f"{by_value} B (FusedSpec {ctypes.sizeof(_kernels.FusedSpec)}, EmitParams "
          f"{ctypes.sizeof(_kernels.EmitParams)}, ActParams {ctypes.sizeof(_kernels.ActParams)}) of 4096", flush=True)
    for tag, (name, kw, build) in CAPS_WORLDS.items():
        env = make_env(name, B, device=dev, seed=0, fused_physics=True, **kw)
        world, fo = env.world, env._fused_outputs
        slots = [a.index for a in env.agents]
        ks = F._kernel_spec(world)
        E, A = ks.E, len(slots)
        carry = F.pack_carry(world, state_from_numpy(world, getattr(testing, build)(env, np.random.default_rng(90))),
                             fo)
        step = F.make_rows_step(world, fo, slots)
        gen = torch.Generator(device=dev).manual_seed(91)
        tr, contacts = ErrTracker(), 0
        for t in range(CAPS_CMP_STEPS):
            act = (torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1).contiguous()
            x = with_actions(carry, act, slots, E)
            contacts += sum(F.contact_counts(world, x).values())
            c_k, e_k = step(carry, act)
            c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
            compare_rows(tr, c_k, c_p, e_k, e_p, f"{tag} rows_step")
            y_k, y_p = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
            compare_rows(tr, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], f"{tag} fused_step")
            carry = c_k
        torch.cuda.synchronize()
        smem = F.group_smem_bytes(ks, True, fo.n_scratch_in, fo.n_ctrl, fo.n_out + fo.n_ctrl_out, A, 8)
        print(f"{tag}@{B}: rows_step and fused_step bitwise their plain versions over {CAPS_CMP_STEPS} re-synced "
              f"steps (E {E}, {A} agents, {fo.n_out} emit rows, {len(ks.ss)} sphere-sphere pairs, {contacts} "
              f"contacts) at {ks.lanes} lane{'s' if ks.lanes > 1 else ''} per env (a block of 8 lanes: {smem} B of "
              f"shared memory, the card's opt-in {F.SMEM_OPTIN}) on {card}", flush=True)
        if contacts == 0:
            raise AssertionError(f"the {tag} comparison saw no contact")
        act = (torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1).contiguous()
        x = with_actions(carry, act, slots, E)
        extra = torch.empty((fo.n_out, B), device=dev)
        times = {
            f"rows_step[{tag}]": kernel_times(f"rows_step[{tag}]", lambda: step(carry, act, extra),
                                              lambda: F.rows_step_plain(world, fo, slots, carry, act),
                                              "fused_step_kernel", plain_calls=3),
            f"fused_step[{tag}]": kernel_times(f"fused_step[{tag}]", lambda: F.fused_step(world, x, fo),
                                               lambda: F.fused_step_plain(world, x, fo), "fused_step_kernel",
                                               plain_calls=3),
        }
        work = {
            f"rows_step[{tag}]": ((2 * carry.shape[0] + 2 * A + fo.n_out) * B * 4,
                                  kernel_ops(ks, carry, fo, rows_form=True)),
            f"fused_step[{tag}]": ((x.shape[0] + 9 * E + fo.n_out) * B * 4, kernel_ops(ks, x, fo)),
        }
        del env, carry, x
        # the main path: 5 env.step calls, then the rows rollout
        F.fused_step_launches = 0
        F.rows_step_launches = 0
        env = make_env(name, num_envs=B, fused_physics=True, **kw)
        assert env.device.type == "cuda"
        env.reset()
        for _ in range(5):
            env.step(env.get_random_actions())
        rgen = torch.Generator(device=dev).manual_seed(0)
        run = rows_rollout_fn(env, horizon=CAPS_HORIZON)
        state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
        n = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
        assert n == {"fused_step": 5, "rows_step": CAPS_HORIZON * (1 + TIMED_CALLS)}, n
        assert bool(torch.isfinite(traj["rewards"]).all()) and bool(torch.isfinite(state.pos).all())
        print(f"main path: {tag} {B} envs x {A} agents x {CAPS_HORIZON} steps, rows_rollout_fn; launches {n}",
              flush=True)
        rollout_report(f"{tag}@{B} rows_rollout_fn", run, state, steps, rgen, call_ms, warm_s, B, card,
                       horizon=CAPS_HORIZON)
        for form, site in (("rows_step", "1603"), ("fused_step", "1425")):
            key = f"{form}[{tag}]"
            e = kernel_entry(key, src, f"vmas_tpu/core/fused.py:{site}", n[form], tr.max(), times[key], *work[key])
            e["launches_on"] = f"{tag}'s main path at {NUM_ENVS} envs, {CAPS_HORIZON}-step calls"
            e["lanes"] = ks.lanes
            entries.append(e)
        del env, state, traj
    return entries


# -- K5: the op-cost probe ----------------------------------------------------------

def opcost_phase(card, dev):
    """The op-cost probe against its plain version, then its path
    (tools/time_opcost.py's op sweep) with the launch count zeroed; the
    slope and intercept; its entry of the kernels line."""
    import importlib.util
    from pathlib import Path

    from vmas_tpu_torch import opcost

    spec = importlib.util.spec_from_file_location("time_opcost", Path(__file__).resolve().parent / "tools" /
                                                  "time_opcost.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    err = tool.check(NUM_ENVS, OPCOST_CHECK_OPS)
    print(f"opcost kernel vs plain at [54, {NUM_ENVS}], n_ops {OPCOST_CHECK_OPS}: ALU chain bitwise (max abs err "
          f"{err['alu']:.3e}), transcendental chain max abs err {err['trans']:.3e} (tolerance atol "
          f"{tool.TRANS_TOL['atol']:g}, rtol {tool.TRANS_TOL['rtol']:g})", flush=True)
    opcost.opcost_launches = 0
    sweep = tool.op_sweep(NUM_ENVS)
    launches = opcost.opcost_launches
    assert launches == len(tool.OPS) * (1 + tool.LAUNCHES + tool.CALLS), launches
    for p in sweep["points"]:
        print(f"opcost n_ops {p['n_ops']}: kernel {p['us']:.3f} us on the device, {p['wall_us']:.3f} us per "
              f"back-to-back call, bound {p['bound_us']:.3f} us ({p['bound_by']})", flush=True)
    print(f"opcost slope {sweep['slope_ns']:.4f} ns per operation per thread, intercept {sweep['intercept_us']:.3f} "
          f"us (device); wall: slope {sweep['wall_slope_ns']:.4f} ns, intercept {sweep['wall_intercept_us']:.3f} us; "
          f"on {card}; launches {launches}", flush=True)
    pt = next(p for p in sweep["points"] if p["n_ops"] == tool.SWEEP_OPS)
    x = tool.probe_inputs(NUM_ENVS)
    plain_ms = time_ms(lambda: opcost.opcost_chain_plain(x, tool.SWEEP_OPS), 5)
    e = kernel_entry("opcost", "vmas_tpu_torch/csrc/opcost.cu", "tests/golden/time_mosaic_opcost.py:73", launches,
                     err["trans"], {"ms": pt["us"] / 1e3, "wall_ms": pt["wall_us"] / 1e3, "plain_ms": plain_ms},
                     2 * tool.R * NUM_ENVS * 4, tool.SWEEP_OPS * NUM_ENVS)
    e.update(n_ops=tool.SWEEP_OPS, alu_max_abs_err=err["alu"], slope_ns=sweep["slope_ns"],
             intercept_us=sweep["intercept_us"], launches_on="tools/time_opcost.py's op sweep")
    return [e]


# -- road_traffic -------------------------------------------------------------

RT_EXACT = ("idx_ref", "idx_l", "idx_r", "coll_l", "coll_r", "short_term")


def rt_sweep_work(tables, pid, S):
    """(bytes, operations) of one path-sweep launch on these lanes, from the
    loops of csrc/road_traffic.cu and this run's paths: per centre-line
    segment 26 (segment set-up 6, point-to-segment distance 19, running
    minimum 1); per boundary segment 181 (set-up 6, the CG's distance 19
    and its minimum 1, 4 corners' squared distances 18 and their minima 1,
    straddle tests 3 + 4 edges x 19); per lane the rectangle (40, cos and
    sin), the edge set-up (2 boundaries x 32) and the corners' 8 roots,
    taken once after their minima. Bytes: pid, pos and rot in, the 16 + 2S
    output rows out, the path tables once."""
    import torch

    Mc, Mb = tables.center.shape[1], tables.left.shape[1]
    meta = tables.meta[pid.reshape(-1)].long()
    nseg = lambda n, M: torch.clamp(torch.clamp(n - 1, max=M - 1), min=1).sum()  # the kernel's n_segments
    seg_c = int(nseg(meta[:, 0], Mc))
    seg_b = int(nseg(meta[:, 1], Mb)) + int(nseg(meta[:, 2], Mb))
    N = pid.numel()
    ops = 26 * seg_c + 181 * seg_b + N * (40 + 2 * TRIG_OPS + 64 + 8)
    table_bytes = sum(t.numel() * t.element_size() for t in (tables.center, tables.left, tables.right, tables.meta))
    return N * (8 + 8 + 4 + 4 * (16 + 2 * S)) + table_bytes, ops


def rt_obs_work(B, A, S, K):
    """(bytes, operations) of one observation launch, from the loops of
    csrc/road_traffic.cu: per (env, ego) own speed 6, cos and sin, 10 per
    short-term point, 3 distances, and per neighbour slot the search over
    the A - 1 others (8 each) plus 52 and a cos and sin for its row. Bytes:
    per agent pos, rot, vel, the short-term points, 4 corners and 3
    distances in; the W-wide row out."""
    W = 1 + 2 * S + 3 + 11 * K
    ops = B * A * (6 + 2 * TRIG_OPS + 10 * S + 3 + K * (8 * (A - 1) + 52 + 2 * TRIG_OPS))
    return B * A * (8 + 4 + 8 + 8 * S + 32 + 12 + 4 * W), ops


def rt_selection(obs, pos, rot, verts, S, K, norm_pos):
    """Which agent each neighbour slot of every observation row [A, B, W]
    holds, -1 where the slot is far-masked: the agent whose 4 corners, in
    the ego's frame, lie nearest the slot's 8 vertex values."""
    import torch

    c, s = torch.cos(rot)[:, :, None, None], torch.sin(rot)[:, :, None, None]
    dx = verts[:, None, :, :4, 0] - pos[:, :, None, None, 0]  # [B, ego, other, 4]
    dy = verts[:, None, :, :4, 1] - pos[:, :, None, None, 1]
    loc = torch.stack([(dx * c + dy * s) / norm_pos, (dy * c - dx * s) / norm_pos], -1).flatten(-2)
    loc = loc.permute(1, 0, 2, 3)  # [ego, B, other, 8]
    picks = []
    for k in range(K):
        o = 1 + 2 * S + 3 + 11 * k
        row = obs[..., o:o + 8]
        far = (row == 1.0).all(-1) & (obs[..., o + 8:o + 10] == 0.0).all(-1) & (obs[..., o + 10] == 1.0)
        idx = (loc - row[:, :, None]).abs().amax(-1).argmin(-1)
        picks.append(torch.where(far, -1, idx))
    return torch.stack(picks, -1)  # [A, B, K]


def rt_forms_sweep(sc, pid, pos, rot, tag):
    """The path-sweep kernel's group form (every group size built) against
    its one-thread form (lanes=1), bitwise on all 16 + 2S output rows;
    raises on any difference."""
    import torch
    from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk

    T = sc._sweep_tables
    ref = rtk.sweep_rows(T, pid, pos, rot, lanes=1, **sc.sweep_kw).view(torch.int32)
    for lanes in rtk.SWEEP_LANES_BUILT[1:]:
        got = rtk.sweep_rows(T, pid, pos, rot, lanes=lanes, **sc.sweep_kw).view(torch.int32)
        if not torch.equal(got, ref):
            raise AssertionError(f"rt_sweep at {lanes} lanes differs from the one-thread form ({tag}): "
                                 f"{int((got != ref).sum())} of {ref.numel()} values")
    print(f"rt_sweep, {tag}: lanes {rtk.SWEEP_LANES_BUILT[1:]} bitwise the one-thread form "
          f"({ref.shape[0]} rows x {ref.shape[1]} lanes)", flush=True)


def rt_compare_sweep(sc, pid, pos, rot, tag):
    """The path-sweep kernel, the group form bitwise the one-thread form and
    the default form against its plain version on these lanes: indices,
    straddle flags and short-term points equal, distances within RT_ATOL.
    Returns the max abs distance error."""
    from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk

    rt_forms_sweep(sc, pid, pos, rot, tag)
    got = rtk.sweep_all(sc._sweep_tables, pid, pos, rot, **sc.sweep_kw)
    want = rtk.sweep_all_plain(sc._sweep_tables, pid, pos, rot, **sc.sweep_kw)
    mism = {k: int((got[k] != want[k]).sum()) for k in RT_EXACT}
    err = max(float((got[k] - want[k]).abs().max()) for k in ("d_ref", "dl5", "dr5"))
    print(f"rt_sweep vs plain, {tag}: {sum(mism.values())} index/flag/short-term mismatches {mism}, "
          f"max abs distance err {err:.3e}; lanes at distance 0 from their centre line (vertex ties) "
          f"{int((want['d_ref'] == 0).sum())}, lanes straddling a boundary "
          f"{int((want['coll_l'] | want['coll_r']).sum())} of {pid.numel()}", flush=True)
    if sum(mism.values()) or err > RT_ATOL:
        raise AssertionError(f"rt_sweep disagrees with its plain version ({tag})")
    return err


def rt_compare_obs(sc, state, tag):
    """The observation kernel, the default (tile) form bitwise the
    one-thread form (tile=0) and against its plain version on one state:
    the same neighbours and far masks, values within RT_ATOL. Returns the
    max abs error."""
    import torch
    from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk

    xs = sc.obs_inputs(state)
    ref = rtk.obs_all(*xs, **sc.obs_kw, tile=0).view(torch.int32)
    got = rtk.obs_all(*xs, **sc.obs_kw)
    if not torch.equal(got.view(torch.int32), ref):
        raise AssertionError(f"rt_obs's default form differs from the one-thread form ({tag}): "
                             f"{int((got.view(torch.int32) != ref).sum())} of {ref.numel()} values")
    print(f"rt_obs, {tag}: tile {rtk.obs_tile(sc.n_agents, sc.sweep_kw['S'], sc.obs_kw['K'], got.device)} "
          f"bitwise the one-thread form", flush=True)
    want = rtk.obs_all_plain(*xs, **sc.obs_kw)
    S, K = sc.sweep_kw["S"], sc.obs_kw["K"]
    sel = [rt_selection(o, xs[0], xs[1], xs[4], S, K, sc.obs_kw["norm_pos"]) for o in (got, want)]
    n_diff = int((sel[0] != sel[1]).sum())
    err = float((got - want).abs().max())
    print(f"rt_obs vs plain, {tag}: {n_diff} neighbour/far-mask mismatches of {sel[0].numel()} slots "
          f"({int((sel[1] < 0).sum())} far-masked), max abs err {err:.3e}", flush=True)
    if n_diff or err > RT_ATOL:
        raise AssertionError(f"rt_obs disagrees with its plain version ({tag})")
    return err


def rt_form_times(name, run, forms, kernel_of):
    """Device ms per launch of each form of one kernel (torch.profiler, 200
    launches), taken in turns: the forms, then the forms in reverse (the
    one-thread form first: one-thread, default, default, one-thread).
    Returns {form: mean ms}, and prints both readings."""
    got = {f: [] for f in forms}
    for f in [*forms, *reversed(forms)]:
        got[f].append(launch_ms(lambda: run(f), 200, kernel_of(f), f"{name} form {f}"))
    print(f"{name} forms, us per launch in turns (forward, reverse): "
          + "; ".join(f"{f}: {v[0] * 1e3:.3f} / {v[1] * 1e3:.3f}" for f, v in got.items()), flush=True)
    return {f: sum(v) / len(v) for f, v in got.items()}


def rt_ptxas_report():
    """Print registers, stack and spills of each road_traffic kernel
    instantiation (``-Xptxas -v``)."""
    import re

    from vmas_tpu_torch import _kernels
    from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk

    n = 0
    for part in _kernels.build_log("road_traffic").split("Compiling entry function '")[1:]:
        m = re.search(r"(rt_\w+?_kernel)(?:ILi(\d+)E)?", part)
        regs = re.search(r"Used (\d+) registers", part)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", part)
        if not (m and regs and frame):
            continue
        tmpl = f"<{m.group(2)}>" if m.group(2) else ""
        print(f"ptxas {m.group(1)}{tmpl}: {regs.group(1)} registers, {frame.group(1)} B stack, "
              f"spill stores {frame.group(2)} B, loads {frame.group(3)} B", flush=True)
        n += 1
    want = len(rtk.SWEEP_LANES_BUILT) + 2  # every sweep form, both observation forms
    if n != want:
        raise AssertionError(f"the build log lists {n} road_traffic kernels, not {want}")


def road_traffic_phase(card, dev):
    """road_traffic's kernels against their one-thread forms and their plain
    versions, each form's time, its main path, and its two entries of the
    kernels line."""
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.parallel.rollout import rollout_fn
    from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk

    B, A = NUM_ENVS, RT_AGENTS
    t_phase = time.perf_counter()
    rt_ptxas_report()
    # -- kernels against their one-thread forms and plain, at full width --------
    env = make_env("road_traffic", B, device=dev, seed=0)
    sc, T = env.scenario, env.scenario._sweep_tables
    S, K = sc.sweep_kw["S"], sc.obs_kw["K"]
    lanes = lambda st: (st.scenario["path_id"].contiguous(),) + tuple(
        t.contiguous() for t in sc._agent_arrays(st)[:2])
    s_reset = env.state
    for _ in range(RT_CMP_STEPS):
        env.step(env.get_random_actions())
    s_steps = env.state
    sweep_err = max(rt_compare_sweep(sc, *lanes(s_reset), "after reset"),
                    rt_compare_sweep(sc, *lanes(s_steps), f"after {RT_CMP_STEPS} random steps"))
    pid, on_c, on_l, rot = testing.rt_vertex_lanes(T, B, A, dev)
    sweep_err = max(sweep_err, rt_compare_sweep(sc, pid, on_c, rot, "on centre-line vertices and padded tails"))
    sweep_err = max(sweep_err, rt_compare_sweep(sc, pid, on_l, rot, "on left-boundary vertices"))
    obs_err = max(rt_compare_obs(sc, s_reset, "after reset"),
                  rt_compare_obs(sc, s_steps, f"after {RT_CMP_STEPS} random steps"))

    # the env with both kernels against the env on the plain path, noise off
    envs = [make_env("road_traffic", B, device=dev, seed=1, is_add_noise=False, pallas_sweeps=k, pallas_obs=k)
            for k in (True, False)]
    ag = torch.Generator(device=dev).manual_seed(6)
    env_err = 0.0
    for t in range(3):
        acts = [torch.stack([torch.rand(B, generator=ag, device=dev) * 2 - 1,
                             (torch.rand(B, generator=ag, device=dev) * 2 - 1) * 0.6], -1) for _ in range(A)]
        (ok, rk, dk, _), (op, rp, dp, _) = (e.step(acts) for e in envs)
        env_err = max(env_err, max(float((a - b).abs().max()) for a, b in zip([*ok, *rk], [*op, *rp])))
        if not torch.equal(dk, dp) or env_err > 5e-5:
            raise AssertionError(f"road_traffic with kernels differs from the plain path at step {t}: {env_err:.3e}")
    print(f"road_traffic env.step with both kernels vs the plain path, 3 steps: max abs obs/reward err "
          f"{env_err:.3e}, dones equal", flush=True)
    del envs

    # each form's device time in turns, then the default form's wall time
    # per call and the plain version's
    print(f"road_traffic: the kernels against their one-thread forms and plain, {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    pid, pos, rot = lanes(s_steps)
    xs = sc.obs_inputs(s_steps)
    sweep_fn = lambda L: rtk.sweep_all(T, pid, pos, rot, **sc.sweep_kw, lanes=L)
    obs_fn = lambda tile: rtk.obs_all(*xs, **sc.obs_kw, tile=tile)
    obs_tile = rtk.obs_tile(A, S, K, dev)
    sweep_us = rt_form_times("rt_sweep", sweep_fn, (1, rtk.SWEEP_LANES),
                             lambda L: "rt_sweep_kernel" if L == 1 else "rt_sweep_group_kernel")
    obs_us = rt_form_times("rt_obs", obs_fn, (0, obs_tile),
                           lambda tile: "rt_obs_kernel" if tile == 0 else "rt_obs_tile_kernel")
    times = {}
    for name, fn, plain, form, thread, by_form in (
            ("rt_sweep", sweep_fn, lambda: rtk.sweep_all_plain(T, pid, pos, rot, **sc.sweep_kw), rtk.SWEEP_LANES, 1,
             sweep_us),
            ("rt_obs", obs_fn, lambda: rtk.obs_all_plain(*xs, **sc.obs_kw), obs_tile, 0, obs_us)):
        times[name] = {"ms": by_form[form], "wall_ms": time_ms(lambda: fn(None), 500), "plain_ms": time_ms(plain, 20)}
        print(f"{name}: default form ({form}) {by_form[form] * 1e3:.3f} us on the device against the one-thread "
              f"form's {by_form[thread] * 1e3:.3f} us, same run; {times[name]['wall_ms'] * 1e3:.3f} us per "
              f"back-to-back call, plain version {times[name]['plain_ms'] * 1e3:.1f} us per call", flush=True)
    sweep_work, obs_work = rt_sweep_work(T, pid, S), rt_obs_work(B, A, S, K)
    del env, s_reset, s_steps, xs

    # -- the main path ----------------------------------------------------------
    print(f"road_traffic: the forms' times, {time.perf_counter() - t_phase:.1f} s", flush=True)
    rtk.sweep_launches = 0
    rtk.obs_launches = 0
    env = make_env("road_traffic", num_envs=B)  # every default: 20 vehicles, map 1, noise, both kernels
    sc = env.scenario
    assert env.device.type == "cuda" and sc.n_agents == A and sc.is_add_noise and sc.pallas_sweeps and sc.pallas_obs
    W = 1 + 2 * S + 3 + 11 * K
    obs = env.reset()
    for _ in range(RT_STEPS):
        obs, rews, dones, infos = env.step(env.get_random_actions())
    assert len(obs) == A and all(o.shape == (B, W) and bool(torch.isfinite(o).all()) for o in obs)
    assert all(r.shape == (B,) and bool(torch.isfinite(r).all()) for r in rews)
    assert dones.shape == (B,) and len(infos) == A

    run = rollout_fn(env, horizon=RT_HORIZON)
    rgen = torch.Generator(device=dev).manual_seed(0)
    state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
    launches = {"rt_sweep": rtk.sweep_launches, "rt_obs": rtk.obs_launches}

    assert traj["rewards"].shape == (RT_HORIZON, B, A) and traj["dones"].shape == (RT_HORIZON, B)
    assert len(traj["obs"]) == A and all(o.shape == (RT_HORIZON, B, W) for o in traj["obs"])
    assert bool(torch.isfinite(traj["rewards"]).all()) and all(bool(torch.isfinite(o).all()) for o in traj["obs"])
    assert bool(torch.isfinite(state.pos).all())
    n_steps = RT_STEPS + RT_HORIZON * (1 + TIMED_CALLS)
    assert int(steps[0]) == n_steps
    # one launch of each kernel per step and per reset (make_env's and env.reset's)
    assert launches == {"rt_sweep": n_steps + 2, "rt_obs": n_steps + 2}, launches
    print(f"main path: rollout_fn road_traffic {B} envs x {A} vehicles x {RT_HORIZON} steps: "
          f"calls {[round(c, 3) for c in call_ms]} ms (warm-up {warm_s:.3f} s), "
          f"best {B * RT_HORIZON / (min(call_ms) / 1e3):.1f} env-steps/s, "
          f"mean {B * RT_HORIZON * TIMED_CALLS / (sum(call_ms) / 1e3):.1f} env-steps/s on {card}; "
          f"launches {launches} ({n_steps} steps, 2 resets)", flush=True)

    # where a main-path call's device time goes (after the counts), on a
    # call of RT_TRACE_STEPS steps against its own wall time
    print(f"road_traffic: the main path, {time.perf_counter() - t_phase:.1f} s", flush=True)
    trace = rollout_fn(env, horizon=RT_TRACE_STEPS)
    wall_ms = time_ms(lambda: trace(state, steps, rgen), 2)
    _, busy_ms, by_name, n_ops, _ = device_ms(lambda: trace(state, steps, rgen), 1, "")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    rt_ms = sum(v for k, v in by_name.items() if "rt_sweep" in k or "rt_obs" in k)
    print(f"device time of one road_traffic rollout_fn call of {RT_TRACE_STEPS} steps: {busy_ms:.3f} ms busy of "
          f"{wall_ms:.3f} ms wall (idle share {1 - busy_ms / wall_ms:.3f}); rt_sweep + rt_obs {rt_ms:.3f} ms; "
          f"{n_ops / RT_TRACE_STEPS:.1f} device operations per step; top: "
          + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top), flush=True)

    src = "vmas_tpu_torch/csrc/road_traffic.cu"
    sweep = kernel_entry("rt_sweep", src, "vmas_tpu/scenarios/road_traffic_kernel.py:403", launches["rt_sweep"],
                         sweep_err, times["rt_sweep"], *sweep_work)
    sweep.update(lanes=rtk.SWEEP_LANES, thread_us=sweep_us[1] * 1e3)
    obs = kernel_entry("rt_obs", src, "vmas_tpu/scenarios/road_traffic_kernel.py:360", launches["rt_obs"],
                       obs_err, times["rt_obs"], *obs_work)
    obs.update(tile=obs_tile, thread_us=obs_us[0] * 1e3)
    del env, state, traj, trace

    # -- maps 2 and 3 and testing mode ------------------------------------------------
    entries = [sweep, obs]
    for tag, (kw, twice, required) in RT_CONFIGS.items():
        entries += rt_config_path(card, dev, tag, kw, twice, required)
    return entries


# road_traffic's other configurations: (make_env kwargs, whether the sweep
# runs twice a step: the per-agent resets of map 3 and testing mode refresh
# the distances), the steps compared, and the events each must show over
# its compared steps and its timed call
RT_CONFIGS = {
    "map2": (dict(map_type="2"), False, ("isb_records", "dones")),
    "testing": (dict(is_testing_mode=True), True, ("resets",)),
    "map3": (dict(map_type="3", n_agents=10), True, ("resets", "dones")),
    "map3,mixed": (dict(map_type="3", n_agents=4, scenario_probabilities=[0.4, 0.3, 0.3]), True,
                   ("resets", "dones")),
}
RT_MAP_CMP_STEPS = 10


def rt_config_path(card, dev, tag, kw, twice, required):
    """One road_traffic configuration at 4096 envs: both kernels against
    their one-thread forms and their plain versions after a reset and after
    RT_MAP_CMP_STEPS random steps from testing.rt_events_state; the ISB records, in-step resets and dones
    counted over those steps and a timed rollout_fn call of RT_HORIZON steps
    with the launch counts zeroed (one sweep a step, two in map 3 and
    testing mode; one observation launch a step); the kernels' device times
    and plain versions'. Returns the two entries of the kernels line."""
    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.parallel.rollout import rollout_fn
    from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk

    B = NUM_ENVS
    t0 = time.perf_counter()
    env = make_env("road_traffic", B, device=dev, seed=0, **kw)
    sc, T = env.scenario, env.scenario._sweep_tables
    A, S, K = sc.n_agents, sc.sweep_kw["S"], sc.obs_kw["K"]
    events = {"isb_records": 0, "resets": 0, "dones": 0}
    place = sc._reset_agents_states

    def counted(state, generator, agent_mask=None):
        if agent_mask is not None:
            events["resets"] += int(agent_mask.sum())
        return place(state, generator, agent_mask)

    sc._reset_agents_states = counted
    lanes = lambda st: (st.scenario["path_id"].contiguous(),) + tuple(
        t.contiguous() for t in sc._agent_arrays(st)[:2])
    s_reset = env.state
    # the events placed (testing.rt_events_state: collisions in the even
    # envs, agents at their exits or entries, or across their lanes, in the
    # odd ones), then random steps
    env.state = testing.rt_events_state(env)
    for _ in range(RT_MAP_CMP_STEPS):
        events["dones"] += int(env.step(env.get_random_actions())[2].sum())
    s_steps = env.state
    sweep_err = max(rt_compare_sweep(sc, *lanes(s_reset), f"{tag}, after reset"),
                    rt_compare_sweep(sc, *lanes(s_steps), f"{tag}, after {RT_MAP_CMP_STEPS} random steps"))
    obs_err = max(rt_compare_obs(sc, s_reset, f"{tag}, after reset"),
                  rt_compare_obs(sc, s_steps, f"{tag}, after {RT_MAP_CMP_STEPS} random steps"))

    # one timed call of the main path, the counts zeroed
    rtk.sweep_launches = 0
    rtk.obs_launches = 0
    run = rollout_fn(env, horizon=RT_HORIZON)
    rgen = torch.Generator(device=dev).manual_seed(0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, steps, traj = run(env.state, env.steps, rgen)
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end)
    launches = {"rt_sweep": rtk.sweep_launches, "rt_obs": rtk.obs_launches}
    assert launches == {"rt_sweep": (2 if twice else 1) * RT_HORIZON, "rt_obs": RT_HORIZON}, (tag, launches)
    events["dones"] += int(traj["dones"].sum())
    if "isb_size" in state.scenario:
        events["isb_records"] = int(state.scenario["isb_size"])
    W = 1 + 2 * S + 3 + 11 * K
    assert traj["rewards"].shape == (RT_HORIZON, B, A) and bool(torch.isfinite(traj["rewards"]).all())
    assert all(o.shape == (RT_HORIZON, B, W) and bool(torch.isfinite(o).all()) for o in traj["obs"])
    assert bool(torch.isfinite(state.pos).all()) and int(steps[0]) == RT_MAP_CMP_STEPS + RT_HORIZON
    missing = [k for k in required if not events[k]]
    if missing:
        raise AssertionError(f"road_traffic {tag} saw no {missing}: {events}")
    print(f"main path: rollout_fn road_traffic {tag} {B} envs x {A} vehicles x {RT_HORIZON} steps: one call "
          f"{call_ms:.3f} ms, {B * RT_HORIZON / (call_ms / 1e3):.1f} env-steps/s on {card}; launches {launches} "
          f"({'two sweeps' if twice else 'one sweep'} a step); over {RT_MAP_CMP_STEPS} + {RT_HORIZON} steps "
          f"{events['isb_records']} ISB records, {events['resets']} agents reset in a step, {events['dones']} "
          f"env dones ({time.perf_counter() - t0:.1f} s)", flush=True)

    pid, pos, rot = lanes(s_steps)
    xs = sc.obs_inputs(s_steps)
    tile = rtk.obs_tile(A, S, K, dev)
    sweep_fn = lambda L: rtk.sweep_all(T, pid, pos, rot, **sc.sweep_kw, lanes=L)
    obs_fn = lambda t: rtk.obs_all(*xs, **sc.obs_kw, tile=t)
    sweep_us = {L: launch_ms(lambda: sweep_fn(L), 200, "rt_sweep_kernel" if L == 1 else "rt_sweep_group_kernel",
                             f"rt_sweep[{tag}] lanes {L}") for L in (1, rtk.SWEEP_LANES)}
    obs_us = {t: launch_ms(lambda: obs_fn(t), 200, "rt_obs_kernel" if t == 0 else "rt_obs_tile_kernel",
                           f"rt_obs[{tag}] tile {t}") for t in sorted({0, tile})}
    times = {
        "rt_sweep": {"ms": sweep_us[rtk.SWEEP_LANES], "wall_ms": time_ms(lambda: sweep_fn(None), 200),
                     "plain_ms": time_ms(lambda: rtk.sweep_all_plain(T, pid, pos, rot, **sc.sweep_kw), 5)},
        "rt_obs": {"ms": obs_us[tile], "wall_ms": time_ms(lambda: obs_fn(None), 200),
                   "plain_ms": time_ms(lambda: rtk.obs_all_plain(*xs, **sc.obs_kw), 5)},
    }
    print(f"rt_sweep[{tag}]: {sweep_us[rtk.SWEEP_LANES] * 1e3:.3f} us on the device at {rtk.SWEEP_LANES} lanes "
          f"({sweep_us[1] * 1e3:.3f} us one-thread), plain {times['rt_sweep']['plain_ms'] * 1e3:.1f} us; "
          f"rt_obs[{tag}]: {obs_us[tile] * 1e3:.3f} us at tile {tile} ({obs_us[0] * 1e3:.3f} us one-thread), "
          f"plain {times['rt_obs']['plain_ms'] * 1e3:.1f} us; {T.center.shape[0]} paths of at most "
          f"{T.center.shape[1]} centre points", flush=True)
    src = "vmas_tpu_torch/csrc/road_traffic.cu"
    on = f"road_traffic {tag}'s rollout_fn call of {RT_HORIZON} steps at {B} envs x {A} vehicles"
    sweep = kernel_entry(f"rt_sweep[{tag}]", src, "vmas_tpu/scenarios/road_traffic_kernel.py:403",
                         launches["rt_sweep"], sweep_err, times["rt_sweep"], *rt_sweep_work(T, pid, S))
    sweep.update(lanes=rtk.SWEEP_LANES, thread_us=sweep_us[1] * 1e3, launches_on=on)
    obs = kernel_entry(f"rt_obs[{tag}]", src, "vmas_tpu/scenarios/road_traffic_kernel.py:360", launches["rt_obs"],
                       obs_err, times["rt_obs"], *rt_obs_work(B, A, S, K))
    obs.update(tile=tile, thread_us=obs_us[0] * 1e3, launches_on=on)
    return [sweep, obs]


def wrapper_phase(card, dev):
    """The gymnasium vectorized wrapper over transport@4096 with the fused
    step: reset and 5 steps with random actions on the card, the outputs as
    numpy arrays of the expected shapes, finite."""
    import numpy as np
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.environment.gym_wrappers import GymnasiumVectorizedWrapper

    B = NUM_ENVS
    env = make_env("transport", B, n_agents=N_AGENTS, seed=0, fused_physics=True, terminated_truncated=True,
                   wrapper="gymnasium_vec")
    assert isinstance(env, GymnasiumVectorizedWrapper) and env.unwrapped.device.type == "cuda"
    obs, info = env.reset(seed=0)
    assert len(obs) == N_AGENTS and all(o.shape == (B, 11) for o in obs)
    t0 = time.perf_counter()
    for _ in range(5):
        obs, rews, terminated, truncated, info = env.step(env.unwrapped.get_random_actions())
    ms = (time.perf_counter() - t0) / 5 * 1e3
    assert all(isinstance(o, np.ndarray) and o.shape == (B, 11) and np.isfinite(o).all() for o in obs)
    assert all(isinstance(r, np.ndarray) and r.shape == (B,) and np.isfinite(r).all() for r in rews)
    assert terminated.shape == (B,) and truncated.shape == (B,) and set(info) == {a.name for a in env.env.agents}
    print(f"wrapper: GymnasiumVectorizedWrapper over transport@{B} (fused step), reset and 5 steps on {card}: "
          f"numpy outputs of the expected shapes, finite; {ms:.3f} ms a step on the host's clock, the copies "
          f"off the card included", flush=True)


# -- 12h. rendering ------------------------------------------------------------

# transport's rows steps and a hook world's env.step calls before its frame,
# frames saved to a video, and the Lidar's rays measured on the card against
# the frame's host copy (the sensor worlds phase's card-vs-CPU tolerance)
RENDER_ROWS_STEPS = 10
RENDER_STEPS = 2
RENDER_VIDEO_FRAMES = 10
RENDER_LIDAR_ATOL = 2e-5
# the calls of a frame's host copy (or of the frame) in one profiler
# session, for its device-to-host copies
RENDER_PROFILE_CALLS = 10


def sync_warnings(fn):
    """``(fn(), the warnings of torch's sync debug mode while it ran)``."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def syncs(fn):
    """``(fn(), the synchronizing CUDA operations it made)``, counted by
    torch's sync debug mode in units of what one ``.cpu()`` of a device
    tensor raises (two warnings in some torch versions): each blocking
    device-to-host copy, each ``.item()`` of a device tensor, is one,
    whether or not the profiler keeps its record."""
    import torch

    unit = sync_warnings(lambda: torch.ones(1, device="cuda").cpu())[1]
    if not unit:
        raise AssertionError("torch's sync debug mode saw no synchronizing operation in a .cpu()")
    out, n = sync_warnings(fn)
    return out, n / unit


def host_ms(fn):
    """The median host ms of 3 calls of ``fn``, after one warm-up call, the
    device idle before each."""
    import torch

    fn()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[1]


def per_leaf_copy(state, k):
    """host_state's row taken with one .cpu() per leaf, the form its packed
    single copy is timed against."""
    import dataclasses

    from vmas_tpu_torch.core.state import WorldState
    from vmas_tpu_torch.render.viewer import _fill, _leaves

    B, tensors = state.batch_dim, []
    tree = _leaves({f.name: getattr(state, f.name) for f in dataclasses.fields(state)}, tensors)
    return WorldState(**_fill(tree, [(t[k:k + 1] if t.ndim and t.shape[0] == B else t).cpu() for t in tensors]))


def host_copy_differs(state, row, k):
    """The leaves of the frame's host copy ``row`` (viewer.host_state) that
    differ from env ``k``'s row of interop's copy of ``state``, in value or
    dtype: [] where the copy is bitwise."""
    from vmas_tpu_torch.interop import state_to_numpy

    B, bad = state.batch_dim, []

    def walk(a, b, path):
        if isinstance(b, dict):
            if set(a) != set(b):
                bad.append(path)
            for key in b:
                walk(a.get(key), b[key], f"{path}.{key}")
        elif isinstance(b, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            want = b[k:k + 1] if b.ndim and b.shape[0] == B else b
            if a is None or a.dtype != want.dtype or not (a == want).all():
                bad.append(path)

    got, ref = state_to_numpy(row), state_to_numpy(state)
    for f in ref:
        walk(got.get(f), ref[f], f)
    return bad


def render_frame(env, k, tag, draw, card, name, cpu_kw, **render_kw):
    """One frame of env ``k``: its host copy held bitwise to interop's and
    timed, against the same row taken one .cpu() a leaf; where ``draw``, the
    frame itself, timed, held bitwise to the frame of the same state copied
    to a CPU env (``make_env(name, **cpu_kw)``) and returned. The frame (its
    host copy where nothing is drawn) must make one synchronizing operation,
    its one device-to-host copy (``syncs``), and the profiler must see no
    more device-to-host copies than that. Returns (frame or None, host-copy
    ms, per-leaf ms, draw ms or None, bytes copied, the profiler's copies a
    frame)."""
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.interop import state_from_numpy, state_to_numpy
    from vmas_tpu_torch.render.viewer import _leaves, host_state

    if draw:
        import matplotlib.pyplot as plt
    copy_ms = host_ms(lambda: host_state(env.state, k))
    leaf_ms = host_ms(lambda: per_leaf_copy(env.state, k))
    (row, _), n_syncs = syncs(lambda: host_state(env.state, k))
    bad = host_copy_differs(env.state, row, k)
    if bad:
        raise AssertionError(f"rendering {tag}: env {k}'s host copy differs from interop's in {bad}")
    leaves = []
    _leaves(row.__dict__, leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    frame, draw_ms = None, None
    if draw:
        t0 = time.perf_counter()
        frame, n_syncs = syncs(lambda: env.render(mode="rgb_array", env_index=k, **render_kw))
        draw_ms = (time.perf_counter() - t0) * 1e3 - copy_ms
        cpu = make_env(name, env.num_envs, device="cpu", seed=0, **cpu_kw)
        cpu.state = state_from_numpy(cpu.world, state_to_numpy(env.state))
        want = cpu.render(mode="rgb_array", env_index=k, **render_kw)
        if frame.shape != want.shape or not (frame == want).all():
            raise AssertionError(f"rendering {tag}: env {k}'s frame differs from the CPU copy's")
        plt.close("all")  # each env's cached figure
        copies = device_ms(lambda: env.render(mode="rgb_array", env_index=k, **render_kw), RENDER_PROFILE_CALLS,
                           "DtoH", per_call=1)[4]
    else:
        copies = device_ms(lambda: host_state(env.state, k), RENDER_PROFILE_CALLS, "DtoH", per_call=1)[4]
    if n_syncs != 1 or copies > n_syncs:
        raise AssertionError(f"rendering {tag}: {n_syncs:g} synchronizing operations a frame and {copies:g} "
                             f"device-to-host copies in the profiler's records, want 1 and at most 1")
    counted = "the profiler's records agree" if copies == 1 else \
        f"the profiler lost records: {copies:g} a frame seen in {PROFILE_TRIES} sessions"
    print(f"rendering {tag} env {k}: host copy {copy_ms:.3f} ms ({nbytes} B in 1 device-to-host copy, the one "
          f"synchronizing operation; {counted}), {leaf_ms:.3f} ms one .cpu() a leaf ({len(leaves)} leaves), "
          f"{len(env.world.entities)} entities, bitwise interop's; "
          + (f"draw {draw_ms:.3f} ms, the frame {frame.shape} bitwise the CPU copy's" if draw else "not drawn")
          + f" on {card}", flush=True)
    return frame, copy_ms, leaf_ms, draw_ms, nbytes, copies


def render_raises(fn):
    """True where ``fn`` raises an ImportError that names matplotlib."""
    try:
        fn()
    except ImportError as e:
        return "matplotlib" in str(e)
    return False


def drawn_artists(env, k):
    """The artists each render hook of ``env`` adds to a fresh Axes at env
    ``k``, reading the frame's host copy."""
    import matplotlib.pyplot as plt
    from vmas_tpu_torch.render.viewer import FrameEnv, host_state

    out = {}
    for hook in ("extra_render", "top_layer_render"):
        fig, ax = plt.subplots()
        getattr(env.scenario, hook)(FrameEnv(env, host_state(env.state, k)[1]), ax, k)
        out[hook] = len(ax.patches) + len(ax.lines) + len(ax.texts) + len(ax.images)
        plt.close(fig)
    return out


def render_phase(card, dev, B=NUM_ENVS):
    """Phase 12h: rendering on the card (see the docstring's 12h)."""
    import importlib.util
    import os
    import tempfile

    import torch
    from vmas_tpu_torch import make_env, testing
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.parallel import rows_rollout_fn
    from vmas_tpu_torch.render.video import save_video
    from vmas_tpu_torch.render.viewer import host_state
    from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk

    draw = importlib.util.find_spec("matplotlib") is not None
    if draw:
        import matplotlib

        matplotlib.use("Agg")
    else:
        print("rendering: matplotlib is not installed here, so no frame is drawn: each frame's host copy is taken, "
              "timed and held bitwise to interop's copy, its device-to-host copies counted, and env.render and "
              "the wrappers' render must raise an ImportError that names matplotlib", flush=True)

    print(f"rendering: one .cpu() of a device tensor raises {sync_warnings(lambda: torch.ones(1, device=dev).cpu())[1]} "
          f"warnings of torch's sync debug mode, the unit a frame's synchronizing operations are counted in",
          flush=True)

    def zero():
        F.fused_step_launches = F.rows_step_launches = 0
        rtk.sweep_launches = rtk.obs_launches = 0

    def counts():
        return {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches,
                "rt_sweep": rtk.sweep_launches, "rt_obs": rtk.obs_launches}

    copies_ms, leaves_ms, draws_ms, sizes, seen, hooks_ms = [], [], [], [], [], []

    def frame(env, k, tag, name, cpu_kw, **render_kw):
        _, copy_ms, leaf_ms, draw_ms, nbytes, copies = render_frame(env, k, f"{tag}@{B}", draw, card, name, cpu_kw,
                                                                    **render_kw)
        copies_ms.append(copy_ms)
        leaves_ms.append(leaf_ms)
        sizes.append(nbytes)
        seen.append(copies)
        if draw:
            draws_ms.append(draw_ms)

    # (a) transport@B: its rows rollout (K2), then the first and last env
    env = make_env("transport", B, device=dev, n_agents=N_AGENTS, seed=0, fused_physics=True)
    zero()
    env.state, env.steps, _ = rows_rollout_fn(env, horizon=RENDER_ROWS_STEPS)(
        env.state, env.steps, torch.Generator(device=dev).manual_seed(0))
    launches = counts()
    if launches["rows_step"] != RENDER_ROWS_STEPS:
        raise AssertionError(f"rendering transport: launches {launches}")
    for k in (0, B - 1):
        frame(env, k, "transport", "transport", {"n_agents": N_AGENTS, "fused_physics": True})
    if not draw and not render_raises(lambda: env.render(mode="rgb_array")):
        raise AssertionError("rendering: env.render did not raise an ImportError naming matplotlib")
    print(f"rendering transport@{B}: after rows_rollout_fn of {RENDER_ROWS_STEPS} steps, launches {launches}",
          flush=True)

    # (b) the hook worlds@B (road_traffic at its defaults: K3/K4), each after
    # RENDER_STEPS env.step calls, fused where the world takes it
    for name, (kw, hooks) in testing.RENDER_HOOK_WORLDS.items():
        kw = {} if name == "road_traffic" else dict(kw)
        t0 = time.perf_counter()
        env = make_env(name, B, device=dev, seed=0, fused_physics=True, **kw)
        zero()
        for _ in range(RENDER_STEPS):
            env.step(env.get_random_actions())
        launches = counts()
        fused = env.world.fused and F.supports(env.world)
        if launches["fused_step"] != (RENDER_STEPS if fused else 0) or (
                name == "road_traffic" and min(launches["rt_sweep"], launches["rt_obs"]) < RENDER_STEPS):
            raise AssertionError(f"rendering {name}: launches {launches}")
        frame(env, 0, name, name, dict(kw, fused_physics=True))
        # the hooks on the card's env, matplotlib recorded (testing.hook_calls),
        # against a CPU twin's on the same host copy
        view = host_state(env.state, 0)[1]
        t1 = time.perf_counter()
        calls, n_syncs = syncs(lambda: testing.hook_calls(env, view, 0))
        hooks_ms.append((time.perf_counter() - t1) * 1e3)
        twin = make_env(name, 1, device="cpu", seed=0, **kw)
        artists = {h: testing.hook_artists(c) for h, c in calls.items()}
        if n_syncs or calls != testing.hook_calls(twin, view, 0) or not all(artists[h] > 0 for h in hooks):
            raise AssertionError(f"rendering {name}: the hooks on the card made {n_syncs:g} synchronizing operations, "
                                 f"added {artists} artists, or asked matplotlib otherwise than on a CPU twin")
        if draw and drawn_artists(env, 0) != artists:
            raise AssertionError(f"rendering {name}: hooks drew {drawn_artists(env, 0)}, recorded {artists}")
        print(f"rendering {name}@{B}: {RENDER_STEPS} env.step, launches {launches}; its hooks on the card's env: "
              f"{sum(map(len, calls.values()))} matplotlib calls, bitwise a CPU twin's, artists {artists}, "
              f"0 synchronizing operations, {hooks_ms[-1]:.3f} ms on the host (recorded, not drawn) "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # (c) flocking's Lidar fans and a position function, a comm world's text;
    # the Lidar on the card against the same rays on the frame's host copy
    env = make_env("flocking", B, device=dev, seed=0, fused_physics=True)
    env.step(env.get_random_actions())
    row, _ = host_state(env.state, 0)
    err = max(float((s.measure(env.state)[0].cpu() - s.measure(row)[0]).abs().max())
              for a in env.world.agents for s in a.sensors)
    if err > RENDER_LIDAR_ATOL:
        raise AssertionError(f"rendering flocking: the Lidar on the card and on the host copy differ by {err}")
    overlays = dict(plot_position_function=lambda p: (p ** 2).sum(-1), plot_position_function_range=1.5,
                    plot_position_function_precision=0.1)
    frame(env, 0, "flocking (fans, arrows, position function)", "flocking", {"fused_physics": True}, **overlays)
    print(f"rendering flocking@{B}: its Lidars on the card vs on the frame's host copy: max abs err {err:.3e} "
          f"(atol {RENDER_LIDAR_ATOL})", flush=True)
    env = make_env("simple_reference", B, device=dev, seed=0, fused_physics=True)
    env.step(env.get_random_actions())
    frame(env, B - 1, "simple_reference (comm text)", "simple_reference", {"fused_physics": True})

    # (d) the wrappers over transport@B, and a video
    wrapped = make_env("transport", B, device=dev, n_agents=N_AGENTS, seed=0, fused_physics=True,
                       terminated_truncated=True, wrapper="gymnasium_vec", wrapper_kwargs={"render_mode": "rgb_array"})
    rllib = make_env("transport", B, device=dev, n_agents=N_AGENTS, seed=0, fused_physics=True, wrapper="rllib")
    if draw:
        for got, want in ((wrapped.render(), wrapped.env.render(mode="rgb_array")),
                          (rllib.try_render_at(B - 1, mode="rgb_array"),
                           rllib.env.render(mode="rgb_array", env_index=B - 1))):
            if not (got == want).all():
                raise AssertionError("rendering: a wrapper's frame differs from its env's")
        with tempfile.TemporaryDirectory() as tmp:
            video = []
            for _ in range(RENDER_VIDEO_FRAMES):
                wrapped.env.step(wrapped.env.get_random_actions())
                video.append(wrapped.render())
            path = save_video(os.path.join(tmp, "transport"), video, fps=10)
            print(f"rendering: {RENDER_VIDEO_FRAMES} frames saved to {os.path.basename(path)} "
                  f"({os.path.getsize(path)} B)", flush=True)
    elif not (render_raises(wrapped.render) and render_raises(lambda: rllib.try_render_at(B - 1, mode="rgb_array"))):
        raise AssertionError("rendering: a wrapper's render did not raise an ImportError naming matplotlib")
    for k in (0, B - 1):
        bad = host_copy_differs(wrapped.env.state, host_state(wrapped.env.state, k)[0], k)
        if bad:
            raise AssertionError(f"rendering the wrapped env: env {k}'s host copy differs in {bad}")
    print(f"rendering: the wrappers over transport@{B}: "
          + ("gymnasium_vec's render and rllib's try_render_at equal their env's frames; "
             f"{RENDER_VIDEO_FRAMES} frames saved" if draw else
             "render and try_render_at raise ImportError naming matplotlib, no video saved (no frames)")
          + f"; host copies of env 0 and {B - 1} bitwise interop's", flush=True)
    def span(xs):
        return f"{min(xs):.3f}-{max(xs):.3f} ms (median {sorted(xs)[len(xs) // 2]:.3f})"

    print(f"rendering on {card}: {len(copies_ms)} frames' host copies {span(copies_ms)}, one device-to-host copy "
          f"and one synchronizing operation a frame, {min(sizes)}-{max(sizes)} B (the profiler saw one copy in "
          f"{sum(c == 1 for c in seen)} of them, fewer in the rest); one .cpu() a leaf {span(leaves_ms)}; "
          f"the hook worlds' hooks {span(hooks_ms)} on the host, recorded; "
          + (f"draw {span(draws_ms)}" if draw else "draw not measured (no matplotlib)"), flush=True)


# -- 12. PPO at transport@4096 ---------------------------------------------------

def ppo_bitwise(env, policy, dev, card):
    """The rows policy rollout (K2) against the env.step policy rollout (K1)
    from one state and one generator seed over PPO_CMP_STEPS steps, bitwise
    in every output and the final state; then, at the policy's actions from
    the path's states, each kernel against its plain version for
    PPO_PLAIN_STEPS re-synced steps, and each kernel timed on the next
    step's carry and the policy's actions. Raises on any difference; returns the
    trackers of the two kernels, their times and that carry."""
    import torch
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.parallel import rollout_fn, rows_policy_rollout_fn

    s0, st0 = contact_rich(env, torch.Generator(device=dev).manual_seed(11)), env.steps
    sa, sta, ta = rollout_fn(env, policy, PPO_CMP_STEPS, policy_aux=True)(
        s0, st0, torch.Generator(device=dev).manual_seed(5))
    sb, stb, tb = rows_policy_rollout_fn(env, policy, PPO_CMP_STEPS, policy_aux=True)(
        s0, st0, torch.Generator(device=dev).manual_seed(5))
    pairs = [("rewards", ta["rewards"], tb["rewards"]), ("dones", ta["dones"], tb["dones"]),
             ("raw", ta["policy_aux"]["raw"], tb["policy_aux"]["raw"]),
             ("logp", ta["policy_aux"]["logp"], tb["policy_aux"]["logp"]), ("steps", sta, stb)]
    pairs += [(f"obs[{i}]", a, b) for i, (a, b) in enumerate(zip(ta["obs"], tb["obs"]))]
    pairs += [(f"obs0[{i}]", a, b) for i, (a, b) in enumerate(zip(ta["obs0"], tb["obs0"]))]
    pairs += [(f"final {f}", getattr(sa, f), getattr(sb, f))
              for f in ("pos", "vel", "rot", "ang_vel", "force", "torque")]
    pairs += [(f"final u[{i}]", a, b) for i, (a, b) in enumerate(zip(sa.u, sb.u))]
    pairs += [(f"final scenario[{k}]", sa.scenario[k], sb.scenario[k]) for k in sa.scenario]
    differ = [name for name, a, b in pairs if not torch.equal(a, b)]
    err = max(float((a.float() - b.float()).abs().max()) for _, a, b in pairs)
    print(f"PPO: env.step policy rollout vs rows_policy_rollout_fn (policy_aux) over {PPO_CMP_STEPS} steps at "
          f"{env.num_envs} envs on {card}: {len(pairs)} outputs, bitwise equal {not differ} (max abs err "
          f"{err:.3e}); rewards shaped in {int((tb['rewards'] != 0).any(-1).sum())} env-steps", flush=True)
    if differ:
        raise AssertionError(f"the rows and env.step policy rollouts differ in {differ}")

    world, fo = env.world, env._fused_outputs
    slots = [a.index for a in env.agents]
    E, A = len(world.spec.mass), len(slots)
    step = F.make_rows_step(world, fo, slots)
    k2, k1 = ErrTracker(), ErrTracker()
    gen = torch.Generator(device=dev).manual_seed(6)
    idx = torch.as_tensor(slots, device=dev)

    def inputs(carry, obs):
        """The policy's action rows on ``obs`` (K2's input) and the carry
        with them written in, as env.step packs it (K1's)."""
        acts = policy(obs, gen)[0]
        act = torch.cat([torch.stack([a[:, 0] for a in acts]), torch.stack([a[:, 1] for a in acts])]).contiguous()
        x = carry.clone()
        x[6 * E + idx], x[7 * E + idx] = act[:A], act[A:]
        return act, x

    carry = F.pack_carry(world, sb, fo)
    obs = env._observations(sb)
    for _ in range(PPO_PLAIN_STEPS):
        act, x = inputs(carry, obs)
        c_k, e_k = step(carry, act)
        c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
        compare_rows(k2, c_k, c_p, e_k, e_p, "rows_step[ppo]")
        y_k, y_p = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
        compare_rows(k1, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], "fused_step[ppo]")
        carry, obs = c_k, fo.unpack(e_k, sb)[0]
    torch.cuda.synchronize()
    act, x = inputs(carry, obs)
    k2.report()
    k1.report()
    extra = torch.empty((fo.n_out, env.num_envs), device=dev)
    times = {
        "rows_step": kernel_times("rows_step[transport,ppo]", lambda: step(carry, act, extra),
                                  lambda: F.rows_step_plain(world, fo, slots, carry, act), "fused_step_kernel"),
        "fused_step": kernel_times("fused_step[transport,ppo]", lambda: F.fused_step(world, x, fo),
                                   lambda: F.fused_step_plain(world, x, fo), "fused_step_kernel"),
    }
    return k2, k1, times, x


def ppo_train(env, card, dev, dtype, seed):
    """TRAIN_UPDATES PPO updates (collect="rows", TRAIN_HORIZON steps, 4
    epochs) a block: one warm-up block and TRAIN_BLOCKS timed blocks (CUDA
    events), with the launch counts zeroed before the first; then one more
    update under the profiler. Checks the counts, the rows kernel's
    records in the profiled update's trace (one a step, read from the
    trace, as the update replays its collection's CUDA graph), a finite
    loss and finite parameters that moved; returns (best env-steps/s, idle
    share, K2 launches)."""
    import torch
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.parallel import init_actor_critic, make_ppo_update, obs_dim_of

    tag = f"PPO update {'bf16' if dtype is not None else 'f32'}"
    model = init_actor_critic(obs_dim_of(env), 2, generator=torch.Generator(device=dev).manual_seed(seed))
    update, make_opt = make_ppo_update(env, horizon=TRAIN_HORIZON, collect="rows", epochs=4, compute_dtype=dtype)
    opt = make_opt(model)
    p0 = [p.detach().clone() for p in model.parameters()]
    gen = torch.Generator(device=dev).manual_seed(seed)
    carry = [env.state, env.steps, None]

    def block():
        for _ in range(TRAIN_UPDATES):
            carry[0], carry[1], carry[2] = update(model, opt, carry[0], carry[1], gen)

    F.fused_step_launches = 0
    F.rows_step_launches = 0
    t0 = time.perf_counter()
    block()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    block_ms = []
    for _ in range(TRAIN_BLOCKS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        block()
        end.record()
        end.synchronize()
        block_ms.append(start.elapsed_time(end))
    launches = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
    n_updates = TRAIN_UPDATES * (1 + TRAIN_BLOCKS)
    if launches != {"fused_step": 0, "rows_step": TRAIN_HORIZON * n_updates}:
        raise AssertionError(f"{tag}: launches {launches}, want {TRAIN_HORIZON} rows steps per update")
    metrics = carry[2]
    loss = float(metrics["loss"])
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(model.parameters(), p0))
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    if not (math.isfinite(loss) and finite and moved > 0):
        raise AssertionError(f"{tag}: loss {loss}, parameters finite {finite}, moved {moved}")
    rate = env.num_envs * TRAIN_HORIZON * TRAIN_UPDATES / (min(block_ms) / 1e3)
    mean = env.num_envs * TRAIN_HORIZON * TRAIN_UPDATES * TRAIN_BLOCKS / (sum(block_ms) / 1e3)
    one = lambda: update(model, opt, carry[0], carry[1], gen)
    _, busy_ms, by_name, n_ops, k2_records = device_ms(one, 1, "fused_step_kernel", TRAIN_HORIZON)
    if k2_records != TRAIN_HORIZON:
        raise AssertionError(f"{tag}: the profiled update's trace holds {k2_records:.0f} rows kernel records, "
                             f"want {TRAIN_HORIZON}")
    upd_ms = min(block_ms) / TRAIN_UPDATES
    idle = 1 - busy_ms / upd_ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"{tag}: {TRAIN_UPDATES} x (horizon {TRAIN_HORIZON}, 4 epochs) at {env.num_envs} envs x "
          f"{env.n_agents} agents: blocks {[round(b, 3) for b in block_ms]} ms (warm-up {warm_s:.3f} s), best "
          f"{rate:.1f} env-steps/s, mean {mean:.1f} env-steps/s on {card}; one update {upd_ms:.3f} ms, device "
          f"{busy_ms:.3f} ms busy (idle share {idle:.3f}, {n_ops:.0f} device operations); loss {loss:.6f}, "
          f"mean reward {float(metrics['mean_reward']):.3e}, parameters finite, moved up to {moved:.3e}; "
          f"launches {launches}; top: " + "; ".join(f"{k[:50]} {v:.3f} ms" for k, v in top), flush=True)
    ppo_split(env, model, opt, dtype, carry, gen, card, tag)
    return rate, idle, launches["rows_step"]


def ppo_split(env, model, opt, dtype, carry, gen, card, tag):
    """Where one update's time goes: its three parts run apart, each timed by
    CUDA events with the device's busy time of the part (profiler) beside
    it: the collection (TRAIN_HORIZON rows policy steps), the batch build
    (values over T+1 steps and GAE), and the 4 epochs of fit."""
    import torch
    from vmas_tpu_torch.parallel import make_gaussian_policy, rows_policy_rollout_fn
    from vmas_tpu_torch.parallel import ppo as P

    pol = make_gaussian_policy(env, dtype=dtype)
    run = rows_policy_rollout_fn(env, lambda obs, g: pol(model, obs, g), TRAIN_HORIZON, policy_aux=True)
    traj = run(carry[0], carry[1], gen)[2]
    batch = P.rows_batch(model, traj, dtype=dtype)
    parts = {
        "collect": lambda: run(carry[0], carry[1], gen),
        "batch": lambda: P.rows_batch(model, traj, dtype=dtype),
        "fit": lambda: P.fit(model, opt, batch, 4, dtype=dtype),
    }
    out = []
    for name, fn in parts.items():
        wall = time_ms(fn, 2)
        _, busy, _, n_ops, _ = device_ms(fn, 1, "")
        out.append(f"{name} {wall:.3f} ms ({busy:.3f} busy, {n_ops:.0f} device operations)")
    print(f"{tag}, one update's parts on {card}: " + "; ".join(out), flush=True)


def ppo_phase(card, dev):
    """PPO at transport@4096, 4 agents (bench.py's training half): the rows
    policy rollout bitwise the env.step policy rollout, each kernel against
    its plain version on the path's inputs, collection at bench.py's
    protocol, full PPO iterations in bf16 and f32, and collect="step".
    Returns the two kernels' trackers, their times on the path's inputs, the
    carry they were timed on, and their launches."""
    import torch
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.parallel import (
        init_actor_critic, make_gaussian_policy, make_ppo_update, obs_dim_of, rows_policy_rollout_fn,
    )

    env = make_env("transport", NUM_ENVS, n_agents=N_AGENTS, seed=0, fused_physics=True)
    model = init_actor_critic(obs_dim_of(env), 2, generator=torch.Generator(device=dev).manual_seed(1))
    pol = make_gaussian_policy(env)
    policy = lambda obs, g: pol(model, obs, g)

    # (a) rows policy rollout against env.step's, and the kernels against plain
    k2, k1, times, carry = ppo_bitwise(env, policy, dev, card)

    # (b) collection at bench.py's protocol: the policy's actions only
    F.fused_step_launches = 0
    F.rows_step_launches = 0
    run = rows_policy_rollout_fn(env, lambda obs, g: pol(model, obs, g)[0], HORIZON)
    rgen = torch.Generator(device=dev).manual_seed(0)
    state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen, calls=COLLECT_CALLS)
    collect_launches = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
    if collect_launches != {"fused_step": 0, "rows_step": HORIZON * (1 + COLLECT_CALLS)}:
        raise AssertionError(f"PPO collection: launches {collect_launches}, want {HORIZON} rows steps a call")
    assert traj["rewards"].shape == (HORIZON, NUM_ENVS, N_AGENTS)
    assert all(o.shape == (HORIZON, NUM_ENVS, 11) and bool(torch.isfinite(o).all()) for o in traj["obs"])
    assert bool(torch.isfinite(traj["rewards"]).all()) and bool(torch.isfinite(state.pos).all())
    assert int(steps[0]) == HORIZON * (1 + COLLECT_CALLS)
    rollout_report(f"PPO collection rows_policy_rollout_fn ({HORIZON} steps a call, launches {collect_launches})",
                   run, state, steps, rgen, call_ms, warm_s, NUM_ENVS, card)

    # (c) full PPO iterations: bf16 (bench.py's) and f32
    train = {name: ppo_train(env, card, dev, dtype, seed=1)
             for name, dtype in (("bf16", torch.bfloat16), ("f32", None))}
    print(f"PPO full iterations on {card}: bf16 {train['bf16'][0]:.1f} env-steps/s (idle {train['bf16'][1]:.3f}), "
          f"f32 {train['f32'][0]:.1f} env-steps/s (idle {train['f32'][1]:.3f})", flush=True)

    # (d) collect="step": env.step (K1) per step, masked resets
    model = init_actor_critic(obs_dim_of(env), 2, generator=torch.Generator(device=dev).manual_seed(1))
    update, make_opt = make_ppo_update(env, horizon=TRAIN_HORIZON, collect="step", epochs=4)
    opt = make_opt(model)
    p0 = [p.detach().clone() for p in model.parameters()]
    gen = torch.Generator(device=dev).manual_seed(2)
    state, steps = env.state, env.steps
    F.fused_step_launches = 0
    F.rows_step_launches = 0
    upd_ms = []
    for _ in range(STEP_UPDATES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, steps, metrics = update(model, opt, state, steps, gen)
        end.record()
        end.synchronize()
        upd_ms.append(start.elapsed_time(end))
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"PPO collect='step': loss {float(metrics['loss'])}")
    step_launches = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}
    if step_launches != {"fused_step": TRAIN_HORIZON * STEP_UPDATES, "rows_step": 0}:
        raise AssertionError(f"PPO collect='step': launches {step_launches}, "
                             f"want {TRAIN_HORIZON} fused steps an update")
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(model.parameters(), p0))
    if not (all(bool(torch.isfinite(p).all()) for p in model.parameters()) and moved > 0):
        raise AssertionError(f"PPO collect='step': parameters not finite or not moved ({moved})")
    rate = NUM_ENVS * TRAIN_HORIZON / (min(upd_ms) / 1e3)
    print(f"PPO update collect='step' f32: {STEP_UPDATES} updates of horizon {TRAIN_HORIZON} (4 epochs) at "
          f"{NUM_ENVS} envs: {[round(u, 3) for u in upd_ms]} ms ({rate:.1f} env-steps/s) on {card}; "
          f"loss {float(metrics['loss']):.6f}, parameters finite, moved up to {moved:.3e}; launches {step_launches}",
          flush=True)
    rows_launches = collect_launches["rows_step"] + sum(t[2] for t in train.values())
    return k2, k1, times, carry, {"rows_step": rows_launches, "fused_step": step_launches["fused_step"]}


# -- 15. utilities and sharding -------------------------------------------------------

UT_STEPS = 10
UT_CHECK_STEPS = 5
UT_TRACE_STEPS = 5
UT_RANKS = 2
UT_RANK_HORIZON = 20
UT_PPO_HORIZON = 32
UT_SWEEP = (4096, 30000)


def _rows_entry(name, env, tr, launches, dev, rows_form, steps=UT_CHECK_STEPS):
    """The K2 (``rows_form``) or K1 entry of the kernels line on ``env``'s
    state: the kernel against its plain version for ``steps`` re-synced
    steps at seeded random actions (bitwise, into ``tr``), then its
    times."""
    import torch
    from vmas_tpu_torch.core import fused as F

    world, fo = env.world, env._fused_outputs
    slots = [a.index for a in env.agents]
    E, A, B = len(world.spec.mass), len(slots), env.num_envs
    R_in = F.rows_layout(world, fo)
    step = F.make_rows_step(world, fo, slots)
    idx = torch.as_tensor(slots, device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    actions = lambda: ((torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1) * 0.6).contiguous()

    def with_actions(carry, act):
        x = carry.clone()
        x[6 * E + idx], x[7 * E + idx] = act[:A], act[A:]
        return x

    carry = F.pack_carry(world, env.state, fo)
    for _ in range(steps):
        act = actions()
        if rows_form:
            c_k, e_k = step(carry, act)
            c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
            compare_rows(tr, c_k, c_p, e_k, e_p, name)
            carry = c_k
        else:
            x = with_actions(carry, act)
            y_k, y_p = F.fused_step(world, x, fo), F.fused_step_plain(world, x, fo)
            compare_rows(tr, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], name)
            carry = y_k[:R_in].contiguous()
    torch.cuda.synchronize()
    act = actions()
    if rows_form:
        extra = torch.empty((fo.n_out, B), device=dev)
        t = kernel_times(name, lambda: step(carry, act, extra), lambda: F.rows_step_plain(world, fo, slots, carry, act),
                         "fused_step_kernel")
        nbytes = (R_in + 2 * A + R_in + fo.n_out) * B * 4
    else:
        x = with_actions(carry, act)
        t = kernel_times(name, lambda: F.fused_step(world, x, fo), lambda: F.fused_step_plain(world, x, fo),
                         "fused_step_kernel")
        nbytes = (R_in + 9 * E + fo.n_out) * B * 4
    replaces = "vmas_tpu/core/fused.py:1603" if rows_form else "vmas_tpu/core/fused.py:1425"
    return kernel_entry(name, "vmas_tpu_torch/csrc/fused_step.cu", replaces, launches, tr.max(), t, nbytes,
                        kernel_ops(F._kernel_spec(world), carry, fo))


def utilities_phase(card, dev):
    """Phase 15: the checkpoint (transport@4096 fused: 10 K2 steps, save, 10
    more; a fresh env loads and takes the same 10 bitwise, npz and dcp,
    with the save and load ms and bytes), checked_step on K1 (bitwise a
    twin's env.step; the NaN and Inf states raise), trace() around K2, two
    gloo ranks on this card (2048 envs each: the rows policy rollout's rows
    bitwise the single-process run's, no collective, then one learner
    step with the parameters equal across ranks, a sharded fit and a
    sharded checkpoint), a one-rank NCCL mesh's PPO update, speed_sweep at
    4096 and 30000 and train_ppo for 2 iterations. Returns the phase's
    entries of the kernels line."""
    import json as _json
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch import testing as T
    from vmas_tpu_torch.checkpoint import load_env, save_env
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.debug import checked_step
    from vmas_tpu_torch.examples import speed_sweep, train_ppo
    from vmas_tpu_torch.interop import state_to_numpy
    from vmas_tpu_torch.parallel import distribute, env_mesh, make_ppo_update, rows_policy_rollout_fn, rows_rollout_fn
    from vmas_tpu_torch.parallel import mesh as M
    from vmas_tpu_torch.parallel.ppo import init_actor_critic, obs_dim_of
    from vmas_tpu_torch.profiling import trace

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ut_")
    entries = []
    kw = dict(n_agents=N_AGENTS, fused_physics=True, device=dev)
    try:
        # -- (a) a checkpointed rows rollout resumed through K2 -------------------------
        env = make_env("transport", NUM_ENVS, seed=0, **kw)
        run = rows_rollout_fn(env, horizon=UT_STEPS)
        env.state, env.steps, _ = run(env.state, env.steps, env.generator)
        sizes, save_ms, load_ms = {}, {}, {}
        for backend in ("npz", "dcp"):
            path = os.path.join(tmp, f"ckpt_{backend}")
            save_ms[backend] = []
            for _ in range(2):  # the first call of a backend in the process, then the next
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                save_env(env, path, backend=backend)
                save_ms[backend].append((time.perf_counter() - t0) * 1e3)
            sizes[backend] = (os.path.getsize(path + ".npz") if backend == "npz" else
                              sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)))
        state_a, steps_a, traj_a = run(env.state, env.steps, env.generator)
        for backend in ("npz", "dcp"):
            other = make_env("transport", NUM_ENVS, seed=5, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            load_env(other, os.path.join(tmp, f"ckpt_{backend}"), backend=backend)
            torch.cuda.synchronize()
            load_ms[backend] = (time.perf_counter() - t0) * 1e3
            F.rows_step_launches = 0
            state_b, steps_b, traj_b = rows_rollout_fn(other, horizon=UT_STEPS)(other.state, other.steps,
                                                                                 other.generator)
            resumed_launches = F.rows_step_launches
            same = (torch.equal(traj_a["rewards"], traj_b["rewards"]) and torch.equal(steps_a, steps_b)
                    and all(torch.equal(a, b) for a, b in zip(traj_a["obs"], traj_b["obs"]))
                    and T.trees_equal(state_to_numpy(state_a), state_to_numpy(state_b)))
            if not same or resumed_launches != UT_STEPS:
                raise AssertionError(f"checkpoint ({backend}): the resumed rows rollout bitwise {same}, "
                                     f"K2 launches {resumed_launches}")
        ms = lambda v: "/".join(f"{x:.3f}" for x in v)
        print(f"checkpoint transport@{NUM_ENVS} on {card}: save npz {ms(save_ms['npz'])} ms (first/second call), "
              f"{sizes['npz']} B; dcp {ms(save_ms['dcp'])} ms, {sizes['dcp']} B; load npz {load_ms['npz']:.3f} ms, "
              f"dcp {load_ms['dcp']:.3f} ms (host clock after a synchronise); the resumed "
              f"{UT_STEPS}-step rows rollouts bitwise the uninterrupted one for both ({resumed_launches} K2 "
              f"launches each)", flush=True)
        k2c = ErrTracker()
        entries.append(_rows_entry("rows_step[transport,checkpoint]", other, k2c, resumed_launches, dev,
                                   rows_form=True))
        print(f"utilities: the checkpoint, {time.perf_counter() - t_phase:.1f} s", flush=True)

        # -- (b) checked_step on K1 ------------------------------------------------------
        env = make_env("transport", NUM_ENVS, seed=1, **kw)
        twin = make_env("transport", NUM_ENVS, seed=1, **kw)
        step = checked_step(env)
        checked_ms, step_ms, checked_launches = [], [], 0
        for _ in range(UT_CHECK_STEPS):
            acts = env.get_random_actions()
            twin.get_random_actions()
            torch.cuda.synchronize()
            F.fused_step_launches = 0
            t0 = time.perf_counter()
            a = step(acts)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            checked_launches += F.fused_step_launches
            b = twin.step(acts)
            torch.cuda.synchronize()
            checked_ms.append((t1 - t0) * 1e3)
            step_ms.append((time.perf_counter() - t1) * 1e3)
            if not all(torch.equal(x, y) for x, y in zip(a[0] + a[1] + [a[2]], b[0] + b[1] + [b[2]])):
                raise AssertionError("checked_step's outputs differ from env.step's")
        if not T.trees_equal(state_to_numpy(env.state), state_to_numpy(twin.state)) or \
                checked_launches != UT_CHECK_STEPS:
            raise AssertionError(f"checked_step: state bitwise env.step's "
                                 f"{T.trees_equal(state_to_numpy(env.state), state_to_numpy(twin.state))}, "
                                 f"K1 launches {checked_launches} in {UT_CHECK_STEPS} checked steps")
        raised = []
        for value in (float("nan"), float("inf")):
            bad = make_env("transport", NUM_ENVS, seed=2, **kw)
            pos = bad.state.pos.clone()
            pos[0, 0, 0] = value
            bad.state = bad.state.replace(pos=pos)
            try:
                checked_step(bad)(bad.get_random_actions())
            except FloatingPointError as e:
                raised.append(str(e))
            else:
                raise AssertionError(f"checked_step did not raise on a {value} position")
        print(f"checked_step transport@{NUM_ENVS} on K1 on {card}: {UT_CHECK_STEPS} steps bitwise env.step's; "
              f"{np.median(checked_ms):.3f} ms a step (median) against env.step's {np.median(step_ms):.3f} ms "
              f"(host clock after a synchronise); the nan and inf states raise: {raised}", flush=True)
        k1c = ErrTracker()
        entries.append(_rows_entry("fused_step[transport,checked_step]", env, k1c, checked_launches, dev,
                                   rows_form=False))
        print(f"utilities: checked_step, {time.perf_counter() - t_phase:.1f} s", flush=True)

        # -- (c) trace() around K2 -----------------------------------------------------------
        run = rows_rollout_fn(env, horizon=UT_TRACE_STEPS)
        found = 0
        for attempt in range(PROFILE_TRIES):
            log_dir = os.path.join(tmp, f"trace{attempt}")
            with trace(log_dir):
                run(env.state, env.steps, env.generator)
            with open(os.path.join(log_dir, "trace.json")) as f:
                events = _json.load(f)["traceEvents"]
            found = sum(e.get("cat") == "kernel" and "fused_step_kernel" in str(e.get("name")) for e in events)
            if found:
                break
        if found < UT_TRACE_STEPS:
            raise AssertionError(f"trace(): {found} records of K2 in the trace of {UT_TRACE_STEPS} launches")
        print(f"trace(): {found} kernel records named fused_step_kernel among {len(events)} events in "
              f"trace.json ({os.path.getsize(os.path.join(log_dir, 'trace.json'))} B; session {attempt + 1})",
              flush=True)

        # -- (d) two gloo ranks on this card ------------------------------------------------
        out = os.path.join(tmp, "ranks")
        t0 = time.perf_counter()
        M.spawn_ranks(UT_RANKS, "vmas_tpu_torch.testing",
                      ["--out", out, "--device", dev.type, "--num_envs", NUM_ENVS, "--horizon", UT_RANK_HORIZON],
                      out, timeout=300, backend="gloo", device=dev)
        ranks_s = time.perf_counter() - t0
        res = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(UT_RANKS)]
        whole = T.mh_env(NUM_ENVS, dev, fused_physics=True)
        run = rows_policy_rollout_fn(whole, T.deterministic_policy, UT_RANK_HORIZON)
        for _ in range(2):  # a warm-up call, then the timed one, as in each rank
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _, traj = run(whole.state, whole.steps, torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        obs = torch.stack(traj["obs"]).cpu().numpy()
        per = NUM_ENVS // UT_RANKS
        for r, x in enumerate(res):
            sl = slice(r * per, (r + 1) * per)
            same = (np.array_equal(x["rewards"], traj["rewards"][:, sl].cpu().numpy())
                    and np.array_equal(x["obs"], obs[:, :, sl]) and np.array_equal(x["pos"], state.pos[sl].cpu().numpy())
                    and np.array_equal(x["dones"], traj["dones"][:, sl].cpu().numpy()))
            if not same or int(x["collectives_rollout"]) or int(x["rows_launches"]) != UT_RANK_HORIZON:
                raise AssertionError(f"rank {r}: rows bitwise {same}, collectives {int(x['collectives_rollout'])}, "
                                     f"K2 launches {int(x['rows_launches'])}")
            if not (bool(x["resumed_npz"]) and bool(x["resumed_dcp"])):
                raise AssertionError(f"rank {r}: the sharded checkpoint did not replay")
        if not (np.array_equal(res[0]["learner"], res[1]["learner"]) and np.array_equal(res[0]["fit"], res[1]["fit"])
                and all(int(x["collectives_learner"]) == 1 for x in res)):
            raise AssertionError("the ranks' learner or fit parameters differ")
        genv = T.mh_env(NUM_ENVS, dev, grad_enabled=True)
        from vmas_tpu_torch.parallel.learner import make_train_step

        params, _, _, loss = make_train_step(genv, horizon=T.MH_LEARNER_HORIZON, lr=T.MH_LR)(
            T.mh_learner(genv), genv.state, genv.steps, torch.Generator(device=dev).manual_seed(0))
        flat = T._flat([t for layer in params for t in (layer["w"], layer["b"])])
        rank_launches = sum(int(x["rows_launches"]) for x in res)
        two_rank_rate = NUM_ENVS * UT_RANK_HORIZON / max(float(x["rollout_s"]) for x in res)
        print(f"two gloo ranks on {card} ({per} envs each, {dev.type} tensors): {ranks_s:.1f} s for both processes "
              f"(start, build load, rollout, learner, fit, checkpoints); each rank's {UT_RANK_HORIZON}-step rows "
              f"policy rollout bitwise the single-process one's rows, no collective, {UT_RANK_HORIZON} K2 launches "
              f"a rank; the two ranks' {UT_RANK_HORIZON}-step calls (started together, host clock after a "
              f"synchronise) {[round(float(x['rollout_s']) * 1e3, 3) for x in res]} ms, {two_rank_rate:.1f} "
              f"env-steps/s for the two together on one card, against {NUM_ENVS * UT_RANK_HORIZON / whole_s:.1f} "
              f"for the single-process {NUM_ENVS}-env call (a check of the mechanism, not a scaling "
              f"number); "
              f"learner parameters equal across ranks after 1 all-reduce, against the single-process step max abs "
              f"diff {float(np.abs(res[0]['learner'] - flat).max()):.3e}, loss {float(res[0]['loss']):.6f} against "
              f"{float(loss):.6f}; sharded fit equal across ranks; sharded npz and dcp checkpoints replay",
              flush=True)
        k2r = ErrTracker()
        entries.append(_rows_entry("rows_step[transport,rank]", T.mh_env(per, dev, fused_physics=True), k2r,
                                   rank_launches, dev, rows_form=True))
        print(f"utilities: the two ranks, {time.perf_counter() - t_phase:.1f} s", flush=True)

        # -- (e) a one-rank NCCL mesh: one sharded PPO update through K2 ---------------------
        if dist.is_initialized():
            raise AssertionError("a process group is running before the NCCL mesh is made")
        mesh = env_mesh(backend="nccl")
        try:
            if dist.get_backend() != "nccl" or mesh.size() != 1:
                raise AssertionError(f"env_mesh made {dist.get_backend()} over {mesh.size()} ranks")
            ones = M.all_reduce(torch.ones(3, device=dev), mesh)
            env = distribute(make_env("transport", NUM_ENVS, seed=3, **kw), mesh)
            model = init_actor_critic(obs_dim_of(env), 2, generator=torch.Generator(device=dev).manual_seed(1),
                                      device=dev)
            update, make_opt = make_ppo_update(env, horizon=UT_PPO_HORIZON, collect="rows", epochs=2)
            F.rows_step_launches = 0
            _, _, metrics = update(model, make_opt(model), env.state, env.steps, torch.Generator(device=dev))
            if F.rows_step_launches != UT_PPO_HORIZON or not all(math.isfinite(float(v)) for v in metrics.values()) \
                    or not torch.equal(ones, torch.ones(3, device=dev)):
                raise AssertionError(f"the NCCL mesh's PPO update: K2 launches {F.rows_step_launches}, metrics "
                                     f"{ {k: float(v) for k, v in metrics.items()} }, all-reduce {ones.tolist()}")
            print(f"one-rank NCCL mesh on {card}: an all-reduce through it, then one PPO update (horizon "
                  f"{UT_PPO_HORIZON}, 2 epochs) on the distributed env, {F.rows_step_launches} K2 launches, loss "
                  f"{float(metrics['loss']):.6f}", flush=True)
        finally:
            dist.destroy_process_group()

        # -- (f) the examples ------------------------------------------------------------------
        rows = speed_sweep.main(n_envs=UT_SWEEP, device=dev)
        if not all(r["rows_s"] is not None and r["rows_s"] > 0 for r in rows):
            raise AssertionError(f"speed_sweep: {rows}")
        model = train_ppo.main(num_envs=NUM_ENVS, iters=2, horizon=UT_PPO_HORIZON, fused_physics=True, device=dev)
        if not all(bool(torch.isfinite(p).all()) for p in model.parameters()) or dist.is_initialized():
            raise AssertionError("train_ppo: parameters not finite, or its process group left running")
        print(f"utilities: the examples, {time.perf_counter() - t_phase:.1f} s", flush=True)
        for tr in (k2c, k1c, k2r):
            tr.report()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return entries


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        sys.exit(1)
    from vmas_tpu_torch import _kernels, make_env
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    # -- 2. build -----------------------------------------------------------
    print(f"build: {_kernels.build_all():.1f} s (nvcc {' '.join(_kernels.NVCC_FLAGS)}; the three sources in "
          f"parallel, fused_step the longest: {FUSED_FORMS} instantiations at each of the lane counts "
          f"{F.LANES_BUILT}; 121.2-156.3 s for 106 before football's emit)", flush=True)
    picked = lane_report(torch.device("cuda"))

    # -- 3. kernel against plain, at full width ------------------------------
    dev = torch.device("cuda")
    env = make_env("transport", NUM_ENVS, device=dev, n_agents=N_AGENTS, seed=0, fused_physics=True)
    world, fo = env.world, env._fused_outputs
    slots = [a.index for a in env.agents]
    ks = F._kernel_spec(world)
    E, A, B = ks.E, len(slots), NUM_ENVS
    R_in = F.rows_layout(world, fo)
    gen = torch.Generator(device=dev).manual_seed(1)
    step = F.make_rows_step(world, fo, slots)

    def acts():
        return ((torch.rand((2 * A, B), generator=gen, device=dev) * 2 - 1) * 0.6).contiguous()

    k2, k1 = ErrTracker(), ErrTracker()
    counts = dict.fromkeys(F.PAIR_TYPES, 0)
    carry = F.pack_carry(world, contact_rich(env, gen), fo)
    for t in range(CMP_STEPS):
        act = acts()
        c_k, e_k = step(carry, act)
        c_p, e_p = F.rows_step_plain(world, fo, slots, carry, act)
        compare_rows(k2, c_k[:9 * E], c_p[:9 * E], e_k, e_p, "rows_step")
        k2.close("rows_step scratch carry", c_k[9 * E:], c_p[9 * E:])
        for k, v in F.contact_counts(world, c_p).items():
            counts[k] += v
        carry = c_k  # re-sync to the kernel

        # the fused step on the same state, as env.step packs it
        x = carry.clone()
        x[6 * E + torch.as_tensor(slots, device=dev)] = act[:A]
        x[7 * E + torch.as_tensor(slots, device=dev)] = act[A:]
        y_k = F.fused_step(world, x, fo)
        y_p = F.fused_step_plain(world, x, fo)
        compare_rows(k1, y_k[:9 * E], y_p[:9 * E], y_k[9 * E:], y_p[9 * E:], "fused_step")
    torch.cuda.synchronize()
    for tr in (k2, k1):
        tr.report()
    print(f"contacts over {CMP_STEPS} steps: {counts['ss']} sphere-sphere, {counts['bs']} box-sphere", flush=True)
    if counts["ss"] == 0 or counts["bs"] == 0:
        raise AssertionError("the comparison saw no contacts of one type")

    # env.step's path (the fused kernel) against the rows path (the rows
    # kernel): one device function, so the same trajectory
    s0, st0 = env.state, env.steps
    g1 = torch.Generator(device=dev).manual_seed(7)
    g2 = torch.Generator(device=dev).manual_seed(7)
    _, _, ta = rollout_fn(env, horizon=CMP_STEPS)(s0, st0, g1)
    _, _, tb = rows_rollout_fn(env, horizon=CMP_STEPS)(s0, st0, g2)
    same = torch.equal(ta["rewards"], tb["rewards"]) and all(torch.equal(a, b) for a, b in zip(ta["obs"], tb["obs"]))
    rollout_err = max(float((a - b).abs().max()) for a, b in zip(ta["obs"], tb["obs"]))
    print(f"env.step rollout vs rows rollout over {CMP_STEPS} steps: bitwise equal {same}, "
          f"max abs obs err {rollout_err:.3e}", flush=True)
    if not same:
        raise AssertionError("env.step rollout and rows rollout differ")

    # per-launch times of each kernel and its plain version: the kernel's
    # own device time (profiler), and the wall time per back-to-back call
    # (CUDA events), which includes the host's launch path
    act = acts()
    x = carry.clone()
    extra = torch.empty((fo.n_out, B), device=dev)
    times = {
        "rows_step": (lambda: step(carry, act, extra), lambda: F.rows_step_plain(world, fo, slots, carry, act)),
        "fused_step": (lambda: F.fused_step(world, x, fo), lambda: F.fused_step_plain(world, x, fo)),
    }
    times = {name: kernel_times(name, kern, plain, "fused_step_kernel") for name, (kern, plain) in times.items()}

    # -- 4. the main path ----------------------------------------------------
    F.fused_step_launches = 0
    F.rows_step_launches = 0
    env = make_env("transport", num_envs=NUM_ENVS, n_agents=N_AGENTS, seed=0, fused_physics=True)
    assert env.device.type == "cuda"
    obs = env.reset()
    for _ in range(5):
        obs, rews, dones, infos = env.step(env.get_random_actions())
    assert all(o.shape == (NUM_ENVS, 4 + 7) and bool(torch.isfinite(o).all()) for o in obs)
    assert all(r.shape == (NUM_ENVS,) and bool(torch.isfinite(r).all()) for r in rews)
    assert dones.shape == (NUM_ENVS,)

    run = rows_rollout_fn(env, horizon=HORIZON)
    rgen = torch.Generator(device=dev).manual_seed(0)
    state, steps, traj, call_ms, warm_s = timed_rollout(run, env.state, env.steps, rgen)
    launches = {"fused_step": F.fused_step_launches, "rows_step": F.rows_step_launches}

    assert traj["rewards"].shape == (HORIZON, NUM_ENVS, N_AGENTS)
    assert traj["dones"].shape == (HORIZON, NUM_ENVS)
    assert len(traj["obs"]) == N_AGENTS and all(o.shape == (HORIZON, NUM_ENVS, 11) for o in traj["obs"])
    assert bool(torch.isfinite(traj["rewards"]).all()) and all(bool(torch.isfinite(o).all()) for o in traj["obs"])
    assert bool(torch.isfinite(state.pos).all())
    assert int(steps[0]) == 5 + HORIZON * (1 + TIMED_CALLS)
    assert launches["fused_step"] == 5, launches
    assert launches["rows_step"] == HORIZON * (1 + TIMED_CALLS), launches
    rate = NUM_ENVS * HORIZON / (min(call_ms) / 1e3)
    print(f"main path: rows_rollout_fn transport {NUM_ENVS} envs x {N_AGENTS} agents x {HORIZON} steps: "
          f"calls {[round(c, 3) for c in call_ms]} ms (warm-up {warm_s:.3f} s), "
          f"best {rate:.1f} env-steps/s, mean {NUM_ENVS * HORIZON * TIMED_CALLS / (sum(call_ms) / 1e3):.1f} "
          f"env-steps/s on {card}; launches {launches}", flush=True)

    # where one main-path call's device time goes (read after the counts:
    # these launches are not the main path's)
    _, busy_ms, by_name, _, _ = device_ms(lambda: run(state, steps, rgen), 1, "")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"device time of one rows_rollout_fn call: {busy_ms:.3f} ms busy of {min(call_ms):.3f} ms wall "
          f"(idle share {1 - busy_ms / min(call_ms):.3f}); top: "
          + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top), flush=True)

    # -- 12h. rendering, run here: the profiler's records of its one small copy
    # a frame are whole early in the process, and lost later (device_ms takes
    # such a session again; the frame's sync count is the witness)
    run_phase("rendering", render_phase, card, dev)

    # -- 5. balance and the all-pairs world ------------------------------------
    balance_kernels = run_phase("balance", balance_phase, card, dev)

    # -- 6. joints: joint_passage and waterfall --------------------------------
    joint_kernels = run_phase("joints", joints_phase, card, dev)

    # -- 7. give_way: the in-kernel PID and k_steps ------------------------------
    give_way_kernels = run_phase("give_way", give_way_phase, card, dev)

    # -- 8. road_traffic -------------------------------------------------------
    rt_kernels = run_phase("road_traffic", road_traffic_phase, card, dev)

    # -- 9. wind_flocking: dynamic gravity -----------------------------------
    wfl_kernels = run_phase("wind_flocking", wind_flocking_phase, card, dev)

    # -- 10. MPE simple and simple_spread --------------------------------------
    mpe_kernels = run_phase("MPE", mpe_phase, card, dev)

    # -- 11. the rest of the MPE family -------------------------------------------
    mpef_kernels = run_phase("MPE family", mpe_family_phase, card, dev)

    # -- 12. the other holonomic worlds, then the lifted caps -------------------
    hol_kernels = run_phase("holonomic", holonomic_phase, card, dev)
    caps_kernels = run_phase("caps", caps_phase, card, dev)

    # -- 12b. the joint worlds, and the rows rollouts' noise streams -------------
    jw_kernels = run_phase("joint worlds", joint_worlds_phase, card, dev)

    # -- 12c. the sensor worlds ---------------------------------------------------
    sw_kernels = run_phase("sensor worlds", sensor_worlds_phase, card, dev)

    # -- 12d. football ---------------------------------------------------------------
    fb_kernels = run_phase("football", football_phase, card, dev)

    # -- 12e. the dynamics and controller debug worlds ------------------------------------
    dw_kernels = run_phase("dynamics and controller worlds", debug_worlds_phase, card, dev)

    # -- 12f. the DOTS and sampling worlds ----------------------------------------------
    dots_kernels = run_phase("DOTS and sampling worlds", dots_worlds_phase, card, dev)

    # -- 12g. a wrapper on the card ----------------------------------------------------
    run_phase("wrapper", wrapper_phase, card, dev)

    # -- 13. the op-cost probe -------------------------------------------------
    opcost_kernels = run_phase("op-cost", opcost_phase, card, dev)

    # -- 14. PPO at transport@4096 ----------------------------------------------
    ppo_k2, ppo_k1, ppo_times, ppo_carry, ppo_launches = run_phase("PPO", ppo_phase, card, dev)

    # -- 15. utilities and sharding ----------------------------------------------
    ut_kernels = run_phase("utilities and sharding", utilities_phase, card, dev)

    # -- 16. the kernels line ------------------------------------------------
    flops = kernel_ops(ks, carry, fo)
    ppo_flops = kernel_ops(ks, ppo_carry, fo)
    rows_bytes = (R_in + 2 * A + R_in + fo.n_out) * B * 4
    fused_bytes = (R_in + 9 * E + fo.n_out) * B * 4
    src = "vmas_tpu_torch/csrc/fused_step.cu"
    kernels = [
        kernel_entry("rows_step", src, "vmas_tpu/core/fused.py:1603", launches["rows_step"], k2.max(),
                     times["rows_step"], rows_bytes, flops),
        kernel_entry("fused_step", src, "vmas_tpu/core/fused.py:1425", launches["fused_step"], k1.max(),
                     times["fused_step"], fused_bytes, flops),
        # the same kernels and shapes on the PPO path: its launches, its
        # comparison with plain and its times, on the policy's inputs
        kernel_entry("rows_step[transport,ppo]", src, "vmas_tpu/core/fused.py:1603", ppo_launches["rows_step"],
                     ppo_k2.max(), ppo_times["rows_step"], rows_bytes, ppo_flops),
        kernel_entry("fused_step[transport,ppo]", src, "vmas_tpu/core/fused.py:1425", ppo_launches["fused_step"],
                     ppo_k1.max(), ppo_times["fused_step"], fused_bytes, ppo_flops),
    ] + (balance_kernels + joint_kernels + give_way_kernels + rt_kernels + wfl_kernels + mpe_kernels + mpef_kernels
         + hol_kernels + jw_kernels + sw_kernels + fb_kernels + dw_kernels + dots_kernels + opcost_kernels
         + ut_kernels)
    entry_lanes(kernels, picked)
    kernels += caps_kernels  # each with its own lanes
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from its start, the build included", flush=True)
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
