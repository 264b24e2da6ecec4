// The fused physics step of vmas_tpu_torch, by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel generated by vmas_tpu/core/fused.py::_make_kernel
// in both of its launch forms:
//   * fused_physics_step (fused.py, pallas_call in its body): one env step,
//     rows [9E + J (+ 2E dynamic gravity) + K_in, B] -> [9E + K_out, B];
//   * make_rows_step (fused.py, rows_mode=True): the rows-carried rollout
//     step, carry [R_in, B] + action rows [K*2A, B] -> carry' + output rows
//     [K*(n_out + n_ctrl_out), B], for K = k_steps whole env steps per launch
//     (fused.py's `for _k in range(k_steps)`), each with the scenario's
//     in-kernel process_action (fused.py process_act_rows: the PID velocity
//     controller, pid_act below) between the action override and physics.
//
// What bounds it on this card. One env's step is a long chain of scalar work
// (joint_passage: some 12,400 operations per substep over 3 joints and 54
// contact pairs), and one thread's dependent chain costs 11.5-12.7 ns per
// operation with its operands in per-thread local memory (the op-cost probe,
// csrc/opcost.cu, on an NVIDIA H100 80GB HBM3 at 700 W). With one thread per env, 4096 envs make 32 blocks of 128
// threads on 132 SMs, and each thread walks every item of its env in turn.
//
// Design: each env on a group of L lanes (L = 4, 8, 16 or 32, a template
// parameter), G = 128 / L envs per block of 128 threads, grid ceil(B / G);
// KernelSpec.lanes (core/fused.py lanes_for) picks L from the world's spec:
// 1 or 8, the two forms the package's build holds (L = 4, 16 and 32 are
// built only with -DVMAS_FUSED_ALL_LANES, tools/time_fused_step.py's build).
//   * Each block copies the world's table (pair records and lane lists) to
//     shared memory, and its G envs' input rows, row by row over neighbouring
//     envs; the env's state stays in shared memory for every substep and, in
//     the rows form, for all k_steps steps of the launch.
//   * Per substep: each entity's own work (action clamps, the accumulators
//     opened with the action force, friction, gravity, cos and sin) on the
//     lane that owns it (e, e + L, ...); then the item types one at a time
//     (joints, ss, ls, ll, bs, bl, bb, never two types in one round, so a
//     warp does not serialise two types' code), lane k on items k, k + L,
//     ... of the type, each writing its force and torques to a buffer; then
//     the lane that owns each entity walks the entity's list of that type's
//     items (KernelSpec.lists) and adds them in the plain version's order.
//     No shuffle tree and no atomic: each sum keeps its order, so the result
//     is bitwise the plain version's. Then the integration, on the owning
//     lane.
//   * The serial parts, the rows form's action override, the PID (pid_act)
//     and the scenario's emit, run on lane 0 of the group against shared
//     memory; the block writes the output rows, coalesced.
//   * __syncwarp orders one group's phases (a group lies in one warp),
//     __syncthreads the block's loads and stores. Every thread runs every
//     phase: a group beyond B computes on zero rows and stores nothing.
// L = 1 is the one-thread form: one thread per env, blocks of 128, the
// env's state in per-thread arrays, the pair tables read from device memory
// and the per-entity constants from a copy in shared memory.
// A world of a few items spends its step in the serial emit, which a group
// runs on one lane of L: there one thread per env does less work per env
// (PERF.md §6).
//
// The world's structure is data, not generated code: the world's scalars
// come by value (FusedSpec), the joint table, the pair tables of all six
// contact types, the lane lists and the per-entity constants as one int32
// device buffer (floats stored by their bits). The arithmetic repeats
// vmas_tpu_torch/core/fused.py's plain version op for op, in its order, so
// it is built with --fmad=false and without fast math (IEEE division and
// square root: the line-line intersection's boundary tests depend on them).
// Closest-point selections take the first strict minimum, as the plain
// version does. The rows form's k_steps loop runs the same ops in the same
// order as K launches of one step, so their rows are bitwise the same.
//
// Bound: bytes for transport and balance, whose pairs are few and cheap
// (transport@4096 moves (55 + 8 + 55 + 47) rows x 4096 x 4 B = 2.70 MB per
// rows step, about 0.8 us at 3.35 TB/s); operations for worlds of many box
// pairs and stiff joints (joint_passage: 509 MFLOP per step at 4096 envs,
// 7.6 us at 67 TFLOP/s). On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
// §6): joint_passage's rows step takes 188.7 us at 8 lanes against 688.8 us
// one thread per env, still 25x its bound. What bounds it now is occupancy:
// 128-157 registers a thread leave some 2 blocks of 4 warps per SM at 4096
// envs, too few to hide the latency of the item rounds, and the emit runs
// on one lane of the group.

#include <cuda_runtime.h>
#include <math.h>

// entities, policy agents (action slots and an emit's per-agent tables) and
// scratch rows; the one-thread form keeps an env's rows in per-thread arrays
// of MAX_E
#define MAX_E 64
#define MAX_A 32
#define MAX_K 16
#define MAX_P 4
// PID-controlled agents; the kernel's by-value parameters (FusedSpec,
// EmitParams, ActParams) stay within the 4 KB that every CUDA 12 toolkit
// takes
#define MAX_PID 8
#define MAX_CTRL (4 * MAX_PID)  // PID memory: accum x, y, prev x, y per agent
// distinct agent radii of an MPE emit's collision tests
#define MAX_RC 4

enum {
  F_MOVABLE = 1, F_ROTATABLE = 2, F_MAX_F = 4, F_F_RANGE = 8, F_MAX_T = 16,
  F_T_RANGE = 32, F_LIN_FRIC = 64, F_ANG_FRIC = 128, F_GRAVITY = 256,
  F_DRAG = 512, F_MAX_SPEED = 1024, F_V_RANGE = 2048,
  F_TRIG = 4096,  // a joint or a pair reads this entity's rotation
};

enum {
  EMIT_NONE = 0, EMIT_TRANSPORT = 1, EMIT_BALANCE = 2, EMIT_JOINT_PASSAGE = 3, EMIT_WATERFALL = 4,
  EMIT_GIVE_WAY = 5, EMIT_MULTI_GIVE_WAY = 6, EMIT_SIMPLE = 7, EMIT_SIMPLE_SPREAD = 8,
  EMIT_SIMPLE_PUSH = 9, EMIT_SIMPLE_ADVERSARY = 10, EMIT_SIMPLE_TAG = 11, EMIT_SIMPLE_REFERENCE = 12,
  EMIT_SPEAKER_LISTENER = 13, EMIT_SIMPLE_WORLD_COMM = 14, EMIT_REVERSE_TRANSPORT = 15, EMIT_WHEEL = 16,
  EMIT_PASSAGE = 17, EMIT_DISPERSION = 18, EMIT_DROPOUT = 19, EMIT_HET_MASS = 20, EMIT_BUZZ_WIRE = 21,
  EMIT_BALL_TRAJECTORY = 22, EMIT_BALL_PASSAGE = 23, EMIT_JOINT_PASSAGE_SIZE = 24, EMIT_NAVIGATION = 25,
  EMIT_FLOCKING = 26, EMIT_DISCOVERY = 27, EMIT_FOOTBALL = 28,
};

// the rows form's in-kernel process_action (ActParams.kind)
enum { ACT_NONE = 0, ACT_PID = 1, ACT_BALL = 2 };

// The per-entity constants, one block of E words per field in the table
// buffer from FusedSpec.o_ent: field f of entity e at o_ent + f * E + e (the
// lanes of a group read neighbouring words). The flags are an int, the
// other fields floats stored by their bits. Both forms read them from a copy
// of the block in the block's shared memory, `ent` (every thread of a warp
// reads one word at a time: a broadcast).
enum {
  P_FLAGS, P_INV_MASS, P_INV_MOI, P_DRAG, P_MAX_F, P_F_RANGE, P_MAX_T, P_T_RANGE, P_MAX_SPEED, P_V_RANGE,
  P_LFM, P_MASS, P_AFM, P_MOI, P_GSX, P_GSY, N_ENT_FIELDS,
};
#define EI(f, e) (ent[(f) * E + (e)])
#define EF(f, e) __int_as_float(ent[(f) * E + (e)])

// vmas_tpu/core/utils.py LINE_MIN_DIST, rounded once to f32
#define LMD_F ((float)(4.0 / 600.0))
#define PI_F 3.14159265358979323846f

// Mirrored field for field by vmas_tpu_torch/_kernels.py (ctypes).
struct FusedSpec {
  int E, J, K_in, substeps;
  // pair counts, and the offsets (in words) of the joint table and the pair
  // tables into the table buffer; J counts the joint records
  int n_ss, n_ls, n_ll, n_bs, n_bl, n_bb;
  int o_j, o_ss, o_ls, o_ll, o_bs, o_bl, o_bb;
  // the lane lists (KernelSpec's): entity e's segment offsets of the seven
  // item types at o_lst + 8e; o_ent: the per-entity constants (P_*);
  // n_tab: the table's length in words
  int o_lst, o_ent, n_tab;
  int n_act, has_x, has_y;
  // dynamic gravity (the fused form only): its 2E rows follow the joint
  // rows, and every movable entity takes mass * (dg + (gsx, gsy)), gsx/gsy
  // then holding the unscaled static gravity, in place of F_GRAVITY's
  // gsx/gsy (which hold mass * static gravity)
  int dyn_g;
  float sub_dt, cm, cf, x_semidim, y_semidim;
  float jf, tcf;  // joint force, torque constraint force
  int act_slot[MAX_A];
};

// each emit's own parameters
struct TransportParams {
  int n_agents, n_pkgs, goal;
  int agent[MAX_A];
  int pkg[MAX_P];
  float hw[MAX_P], hl[MAX_P];
  float og_dmin;  // goal radius + LINE_MIN_DIST
  float factor;   // shaping factor
};

struct BalanceParams {
  int n_agents;
  int agent[MAX_A];
  int goal, pkg, line, floor;
  float pkg_r, goal_r;
  float pkg_dmin;  // package radius + LINE_MIN_DIST, rounded once
  float line_half, floor_hw, floor_hl;
  float factor, fall_rew;
};

struct JointPassageParams {
  int n_agents;
  int agent[MAX_A];
  int jl, goal;  // the joint's line, the goal line
  int n_open;
  int open[MAX_E];  // the open passages, in their order
  float pw_half;    // passage width / 2
  float pos_f, rot_f, middle;
  int all_rot, obs_joint;
};

struct WaterfallParams {
  int n_agents;
  int agent[MAX_A];
  int n_lm;
  int lm[MAX_E];  // every landmark, in world order
  int goal;
};

struct GiveWayParams {
  int n_agents;
  int agent[MAX_A], goal[MAX_A];  // each agent and its goal
  float goal_r[MAX_A];
  float factor, final;  // shaping factor, final reward
  int rel_obs;          // observe the other agents' relative positions
};

struct MultiGiveWayParams {
  int n_agents;
  int agent[MAX_A], goal[MAX_A];
  float goal_r[MAX_A];
  float factor;
  int factor_zero;  // a shaping factor of 0: per-agent reward -dist * 1e-4
  float final, coll_pen, min_coll;
  float two_r;      // 2 * agent radius, rounded once
};

// MPE simple and simple_spread: the policy agents are entities a0 ..
// a0 + n_agents - 1 and the landmarks l0 .. l0 + n_lm - 1 (the host checks
// that they are contiguous), which keeps the by-value budget
struct SimpleParams {
  int n_agents, a0, n_lm, l0;
};

struct SimpleSpreadParams {
  int n_agents, a0, n_lm, l0;
  int obs_others;       // observe the other agents' relative positions
  float radius[MAX_A];  // each agent's radius
};

// simple_push and simple_adversary: the agents and landmarks as above, and
// which agents are adversaries
struct MpeTeamParams {
  int n_agents, a0, n_lm, l0;
  int adversary[MAX_A];
};

// simple_tag: each agent's role, whether it collides and its radius class;
// hit_r[i * MAX_RC + j], the collision distance of classes i and j (the two
// radii summed in double precision on the host and rounded once, as the
// JAX package compares against the Python sum); the reward and observation
// flags
struct SimpleTagParams {
  int n_agents, a0, n_lm, l0;
  int adversary[MAX_A], collide[MAX_A], rcls[MAX_A];
  float hit_r[MAX_RC * MAX_RC];
  int shape_agent, shape_adv, same_team, obs_pos, obs_vel;
};

struct SpeakerListenerParams {
  int n_agents, listener, n_lm, l0;
};

// simple_world_comm: as simple_tag's, with the leader, the food entities f0
// .. f0 + n_food - 1 and food_r, each radius class's distance to a food
// item (rounded once on the host)
struct SimpleWorldCommParams {
  int n_agents, a0, n_lm, l0, f0, n_food;
  int adversary[MAX_A], leader[MAX_A], collide[MAX_A], rcls[MAX_A];
  float hit_r[MAX_RC * MAX_RC];
  float food_r[MAX_RC];
};

struct ReverseTransportParams {
  int n_agents;
  int agent[MAX_A];
  int goal, pkg;
  float hw, hl;   // the package's half width and half length
  float og_dmin;  // goal radius + LINE_MIN_DIST, rounded once
  float factor;
};

struct WheelParams {
  int n_agents;
  int agent[MAX_A];
  int line;
  float half, v_des;  // the line's half length, the desired angular speed
};

// passage: each agent, its goal and whether it collides; the open passages
// and the walls (the passages that collide), each in world order; the
// thresholds rounded once from the double expressions the JAX package
// compares against
struct PassageParams {
  int n_agents;
  int agent[MAX_A], goal[MAX_A], collide[MAX_A];
  int n_open, n_walls;
  int open[MAX_E], wall[MAX_E];
  float hw, hl;     // a wall's half width and half length
  float two_r;      // 2 * agent radius
  float wall_dmin;  // agent radius + LINE_MIN_DIST
  float half_r;     // agent radius / 2, the goal's reach
  float factor;
};

struct DispersionParams {
  int n_agents, n_food;
  int agent[MAX_A], food[MAX_K];
  float eat_r[MAX_A];  // each agent's radius + the food's, rounded once
  int share, by_time;  // share_reward, penalise_by_time
};

struct DropoutParams {
  int n_agents, goal;
  int agent[MAX_A];
  float eat_r[MAX_A];  // each agent's radius + the goal's, rounded once
};

struct HetMassParams {
  int n_agents;
  int agent[MAX_A];
};

// buzz_wire: the collidables (the agents, then the ball) with their radii,
// and the lines (the walls, then the floors) with their half lengths
struct BuzzWireParams {
  int n_agents;
  int agent[MAX_A];
  int ball, goal;
  int n_coll;
  int coll[MAX_A + 1];
  float coll_r[MAX_A + 1];
  int n_lines;
  int line[MAX_E];
  float half[MAX_E];
  float factor, coll_pen;
};

struct BallTrajectoryParams {
  int n_agents;
  int agent[MAX_A];
  int ball;
  float R;  // the circle's radius
  float pos_f, speed_f, dist_f, v_des;
};

// ball_passage: the collidables (the agents, then the ball) with their
// contact distances (radius + LINE_MIN_DIST, rounded once), the open
// passages and the walls, each in world order; lo and hi: the arena bounds
// of done (-1 + ball radius, 1 - ball radius, rounded once)
struct BallPassageParams {
  int n_agents;
  int agent[MAX_A];
  int ball, goal;
  int n_coll;
  int coll[MAX_A + 1];
  float coll_dmin[MAX_A + 1];
  int n_open, n_walls;
  int open[MAX_E], wall[MAX_E];
  float hw, hl;  // a wall's half width and half length
  float factor, coll_pen, lo, hi;
};

struct JointPassageSizeParams {
  int n_agents;
  int agent[MAX_A];
  int jl, goal;
  float pw_half, pos_f, rot_f;
  int mid_180, obs_joint;
};

// navigation: each agent, its goal, its goal's radius and its own;
// pair_mask[i] has bit j set where agents i > j collide
struct NavigationParams {
  int n_agents;
  int agent[MAX_A], goal[MAX_A];
  float goal_r[MAX_A], done_r[MAX_A];
  unsigned int pair_mask[MAX_A];
  float factor, final, coll_pen, min_coll;
  int all_goals;
};

// flocking: every agent in world order (the scripted target first) with its
// radius and policy slot (-1: scripted), each policy agent's position in
// that order
struct FlockingParams {
  int n_agents, n_all, target;
  int all[MAX_A + 1];
  float radius[MAX_A + 1];
  int slot[MAX_A + 1];
  int policy[MAX_A];
  float coll_rew, min_coll, desired, factor;
};

struct DiscoveryParams {
  int n_agents, n_targets;
  int agent[MAX_A];
  float radius[MAX_A];
  int target[MAX_E];
  float cover_r, per_target, coeff, coll_pen, min_coll;
  int with_coll;
};

// football: the policy agents with their team (1: blue), both teams'
// entities, the ball, the score's and the shaping's constants, and which
// dense terms (per team) and observation blocks the config has
struct FootballParams {
  int n_agents, n_blue, n_red, ball;
  int agent[MAX_A], blue[MAX_A], blue_i[MAX_A], red_i[MAX_A];
  float gx, x_over, y_goal, scoring, f_goal, f_agent, trigger;
  int dense_blue, dense_red, obs_adv, obs_team;
};

// A launch runs one emit and reads only its parameters: a union, each
// scenario's kernel_emit() filling its own member.
struct EmitParams {
  int carry_idx[MAX_K];  // emit row feeding scratch row k; -1 = unchanged
  union {
    TransportParams transport;
    BalanceParams balance;
    JointPassageParams joint_passage;
    WaterfallParams waterfall;
    GiveWayParams give_way;
    MultiGiveWayParams multi_give_way;
    SimpleParams simple;
    SimpleSpreadParams simple_spread;
    MpeTeamParams simple_push;
    MpeTeamParams simple_adversary;
    SimpleTagParams simple_tag;
    SimpleParams simple_reference;
    SpeakerListenerParams speaker_listener;
    SimpleWorldCommParams simple_world_comm;
    ReverseTransportParams reverse_transport;
    WheelParams wheel;
    PassageParams passage;
    DispersionParams dispersion;
    DropoutParams dropout;
    HetMassParams het_mass;
    BuzzWireParams buzz_wire;
    BallTrajectoryParams ball_trajectory;
    BallPassageParams ball_passage;
    JointPassageSizeParams joint_passage_size;
    NavigationParams navigation;
    FlockingParams flocking;
    DiscoveryParams discovery;
    FootballParams football;
  };
};

// football's ball script (fused.py BallScriptActRows): the ball's entity and
// the script's constants
struct BallScriptParams {
  int slot;
  float dist_thres, vel_thres, impulse, pw_half, pl_half, y_goal;
};

// The rows form's in-kernel process_action, of kind `kind`: ACT_NONE runs
// none (the fused step, and the rows step of most scenarios); ACT_PID the
// PID velocity controller (fused.py PidActRows): per PID-controlled agent its
// entity slot, the optional clamp of u to u_rng, min_in (0: no zeroing) and
// the VelocityController's constants; ACT_BALL football's ball script.
struct ActParams {
  int kind;
  int n_pid;
  int slot[MAX_PID], clamp[MAX_PID];
  float u_rng[MAX_PID], min_in[MAX_PID], dt[MAX_PID], gain[MAX_PID], mass[MAX_PID];
  int use_i[MAX_PID];
  float inv_ti[MAX_PID];
  int has_cutoff[MAX_PID];
  float cutoff[MAX_PID], td[MAX_PID];
  BallScriptParams ball;
};

// The carry rows of the in-kernel process_action (the PID's memory: 4 per
// agent) and its output rows after each step's emit rows (the PID's forces,
// 2 per agent; the ball's u, 2).
__host__ __device__ inline int act_ctrl_rows(const ActParams& ap) { return ap.kind == ACT_PID ? 4 * ap.n_pid : 0; }
__host__ __device__ inline int act_out_rows(const ActParams& ap) {
  return ap.kind == ACT_PID ? 2 * ap.n_pid : (ap.kind == ACT_BALL ? 2 : 0);
}

// The kernel's parameters by value: the three structs, five pointers and
// three ints, within the 4 KB that every CUDA 12 toolkit takes.
static_assert(sizeof(FusedSpec) + sizeof(EmitParams) + sizeof(ActParams) + 5 * sizeof(void*) + 3 * sizeof(int) <=
                  4096,
              "the fused kernel's by-value parameters exceed 4 KB");

// ---------------------------------------------------------------------------
// helpers (fused.py: _norm, _logaddexp0, _constraint_force, ...)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float nrm(float x, float y) {
  float sq = x * x + y * y;
  return sq == 0.f ? 0.f : sqrtf(sq);
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__device__ __forceinline__ float logaddexp0(float x) {
  return (x > 0.f ? x : 0.f) + log1pf(expf(-fabsf(x)));
}

// Repulsive penalty force on a (negate for b). The drop conditions keep the
// JAX package's order: too close to have a direction, or out of contact.
__device__ __forceinline__ void constraint_force(float cm, float cf, float ax, float ay,
                                                 float bx, float by, float dmin,
                                                 float& fx, float& fy) {
  float dx = ax - bx, dy = ay - by;
  float dist = nrm(dx, dy);
  float pen = logaddexp0((dmin - dist) / cm) * cm;
  float scale = cf * pen / (dist > 0.f ? dist : 1e-8f);
  fx = dx * scale;
  fy = dy * scale;
  if (dist < 1e-6f || dist > dmin) {
    fx = 0.f;
    fy = 0.f;
  }
}

// The attractive form: pulls a toward b beyond dmin. The sign comes before
// the division by cm, and the force is dropped inside dmin (fused.py
// _constraint_force with attractive=True).
__device__ __forceinline__ void constraint_force_att(float cm, float cf, float ax, float ay,
                                                     float bx, float by, float dmin,
                                                     float& fx, float& fy) {
  float dx = ax - bx, dy = ay - by;
  float dist = nrm(dx, dy);
  float pen = logaddexp0((dmin - dist) * -1.f / cm) * cm;
  float scale = -cf * pen / (dist > 0.f ? dist : 1e-8f);
  fx = dx * scale;
  fy = dy * scale;
  if (dist < 1e-6f || dist < dmin) {
    fx = 0.f;
    fy = 0.f;
  }
}

// jnp.mod(x, pi) / torch.remainder(x, pi): fmod, then the divisor's sign
__device__ __forceinline__ float mod_pi(float x) {
  float r = fmodf(x, PI_F);
  if (r != 0.f && (r < 0.f) != (PI_F < 0.f)) r = r + PI_F;
  return r;
}

__device__ __forceinline__ void closest_point_line(float lx, float ly, float c, float s,
                                                   float half, float px, float py,
                                                   float& ox, float& oy) {
  float dot = (lx - px) * c + (ly - py) * s;
  float sg = sgn(dot);
  float dist = fminf(fabsf(dot), half);
  ox = lx - sg * dist * c;
  oy = ly - sg * dist * s;
}

// Closest point on a box's perimeter to (tx, ty): the edges in the order
// +length, -length, +width, -width; the first strict minimum wins.
__device__ __forceinline__ void closest_point_box(float px, float py, float c, float s, float hw, float hl,
                                  float tx, float ty, float& bx, float& by) {
  float wx = -s, wy = c;
  float ex[4] = {px + c * hl, px - c * hl, px + wx * hw, px - wx * hw};
  float ey[4] = {py + s * hl, py - s * hl, py + wy * hw, py - wy * hw};
  float ec[4] = {wx, wx, c, c};
  float es[4] = {wy, wy, s, s};
  float eh[4] = {hw, hw, hl, hl};
  float bd = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float cx, cy;
    closest_point_line(ex[k], ey[k], ec[k], es[k], eh[k], tx, ty, cx, cy);
    float d = nrm(cx - tx, cy - ty);
    if (k == 0 || d < bd) {
      bx = cx;
      by = cy;
      bd = d;
    }
  }
}

// geometry.inner_point_box on one lane; the degenerate lane substitutes the
// surface point for the offset (inner = 2 * surface), as the JAX package does.
__device__ __forceinline__ void inner_point_box(float ox, float oy, float sx, float sy,
                                                float bx, float by, float& ix, float& iy,
                                                float& d) {
  float vx = sx - ox, vy = sy - oy;
  float ux = bx - sx, uy = by - sy;
  float vn = nrm(vx, vy);
  float den = vn == 0.f ? 1.f : vn;
  float mag = (vx * ux + vy * uy) / den;
  float xx = vx / den * mag, xy = vy / den * mag;
  bool degenerate = vn == 0.f;
  ix = sx + (degenerate ? sx : xx);
  iy = sy + (degenerate ? sy : xy);
  d = degenerate ? 0.f : fabsf(mag);
}

// Edge k of a box as (centre, direction, half length), in the order
// +length, -length, +width, -width (fused.py _box_edges).
__device__ __forceinline__ void box_edge(int k, float px, float py, float c, float s, float hw, float hl,
                                         float& ex, float& ey, float& ec, float& es, float& eh) {
  const float wx = -s, wy = c;
  if (k == 0) { ex = px + c * hl; ey = py + s * hl; ec = wx; es = wy; eh = hw; }
  else if (k == 1) { ex = px - c * hl; ey = py - s * hl; ec = wx; es = wy; eh = hw; }
  else if (k == 2) { ex = px + wx * hw; ey = py + wy * hw; ec = c; es = s; eh = hl; }
  else { ex = px - wx * hw; ey = py - wy * hw; ec = c; es = s; eh = hl; }
}

// First-min-wins update of a running closest pair (fused.py _pick_closest).
__device__ __forceinline__ void pick(bool first, float c1x, float c1y, float c2x, float c2y, float& bd,
                                     float& p1x, float& p1y, float& p2x, float& p2y) {
  float d = nrm(c1x - c2x, c1y - c2y);
  if (first || d < bd) {
    p1x = c1x; p1y = c1y; p2x = c2x; p2y = c2y; bd = d;
  }
}

// Closest points of two segments, (point on a, point on b): the
// intersection where they cross, else the first closest of (a1, a1 on b),
// (a2, a2 on b), (b1 on a, b1), (b2 on a, b2). A parallel pair divides by 1
// and never crosses (fused.py _intersection, _closest_points_line_line).
__device__ __noinline__ void closest_points_line_line(float ax, float ay, float ac, float as, float ah,
                                                      float bx, float by, float bc, float bs, float bh,
                                                      float& pax, float& pay, float& pbx, float& pby) {
  const float a1x = ax + ac * ah, a1y = ay + as * ah, a2x = ax - ac * ah, a2y = ay - as * ah;
  const float b1x = bx + bc * bh, b1y = by + bs * bh, b2x = bx - bc * bh, b2y = by - bs * bh;
  const float rx = a2x - a1x, ry = a2y - a1y;
  const float sx = b2x - b1x, sy = b2y - b1y;
  const float qpx = b1x - a1x, qpy = b1y - a1y;
  const float cross_qp_r = qpx * ry - qpy * rx;
  const float cross_qp_s = qpx * sy - qpy * sx;
  const float cross_r_s = rx * sy - ry * sx;
  const float den = cross_r_s == 0.f ? 1.f : cross_r_s;
  const float u = cross_qp_r / den;
  const float t = cross_qp_s / den;
  const bool hit = (cross_r_s != 0.f) && (t >= 0.f) && (t <= 1.f) && (u >= 0.f) && (u <= 1.f);
  if (hit) {
    pax = pbx = a1x + t * rx;
    pay = pby = a1y + t * ry;
    return;
  }
  float bd, ox, oy;
  closest_point_line(bx, by, bc, bs, bh, a1x, a1y, ox, oy);
  pick(true, a1x, a1y, ox, oy, bd, pax, pay, pbx, pby);
  closest_point_line(bx, by, bc, bs, bh, a2x, a2y, ox, oy);
  pick(false, a2x, a2y, ox, oy, bd, pax, pay, pbx, pby);
  closest_point_line(ax, ay, ac, as, ah, b1x, b1y, ox, oy);
  pick(false, ox, oy, b1x, b1y, bd, pax, pay, pbx, pby);
  closest_point_line(ax, ay, ac, as, ah, b2x, b2y, ox, oy);
  pick(false, ox, oy, b2x, b2y, bd, pax, pay, pbx, pby);
}

// Closest pair of a box's perimeter and a segment, (point on the box,
// point on the segment), over the box's edges in box_edge order.
__device__ __noinline__ void closest_line_box(float px, float py, float c, float s, float hw, float hl,
                                              float lx, float ly, float lc, float ls, float lh,
                                              float& qbx, float& qby, float& qlx, float& qly) {
  float bd = 0.f;
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    float ex, ey, ec, es, eh, p1x, p1y, p2x, p2y;
    box_edge(k, px, py, c, s, hw, hl, ex, ey, ec, es, eh);
    closest_points_line_line(ex, ey, ec, es, eh, lx, ly, lc, ls, lh, p1x, p1y, p2x, p2y);
    pick(k == 0, p1x, p1y, p2x, p2y, bd, qbx, qby, qlx, qly);
  }
}

// Closest pair of two box perimeters, (point on a, point on b): a's edges
// against b's perimeter first, then b's edges against a's (fused.py
// _bb_closest).
__device__ __noinline__ void bb_closest(float ax, float ay, float ca, float sa, float hwa, float hla,
                                        float bx, float by, float cb, float sb, float hwb, float hlb,
                                        float& qax, float& qay, float& qbx, float& qby) {
  float bd = 0.f;
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    float ex, ey, ec, es, eh, ona_x, ona_y, onb_x, onb_y;
    if (k < 4) {
      box_edge(k, ax, ay, ca, sa, hwa, hla, ex, ey, ec, es, eh);
      closest_line_box(bx, by, cb, sb, hwb, hlb, ex, ey, ec, es, eh, onb_x, onb_y, ona_x, ona_y);
    } else {
      box_edge(k - 4, bx, by, cb, sb, hwb, hlb, ex, ey, ec, es, eh);
      closest_line_box(ax, ay, ca, sa, hwa, hla, ex, ey, ec, es, eh, ona_x, ona_y, onb_x, onb_y);
    }
    pick(k == 0, ona_x, ona_y, onb_x, onb_y, bd, qax, qay, qbx, qby);
  }
}

// ---------------------------------------------------------------------------
// the in-kernel process_action: the PID velocity controller
// ---------------------------------------------------------------------------

// fused.py PidActRows and velocity_controller.py rows_step, op for op, per
// agent: the clamp of u (the decoded action in the force rows) to u_rng on
// the unguarded norm; zeroing below min_in on the guarded norm; the reset
// of the memory c (accum x, y, prev x, y) below 1e-3; then the update. The
// force replaces u in the force rows and goes to the hook rows (2 per agent,
// row stride B).
__device__ __forceinline__ void pid_act(const ActParams& ap, float* fx, float* fy, const float* vx,
                                        const float* vy, float* ctrl, float* hook, int B, int b) {
  for (int i = 0; i < ap.n_pid; ++i) {
    const int e = ap.slot[i];
    float ux = fx[e], uy = fy[e];
    if (ap.clamp[i]) {
      const float n = sqrtf(ux * ux + uy * uy);
      const float rng = ap.u_rng[i];
      if (n > rng) {
        ux = ux / n * rng;
        uy = uy / n * rng;
      }
    }
    if (nrm(ux, uy) < ap.min_in[i]) {
      ux = 0.f;
      uy = 0.f;
    }
    float* c = ctrl + 4 * i;
    if (nrm(ux, uy) < 1e-3f) c[0] = c[1] = c[2] = c[3] = 0.f;
    const float ex = ux - vx[e], ey = uy - vy[e];
    float ix = 0.f, iy = 0.f;
    if (ap.use_i[i]) {
      c[0] = c[0] + ap.dt[i] * ex;
      c[1] = c[1] + ap.dt[i] * ey;
      if (ap.has_cutoff[i]) {
        const float cut = ap.cutoff[i];
        c[0] = fminf(fmaxf(c[0], -cut), cut);
        c[1] = fminf(fmaxf(c[1], -cut), cut);
      }
      ix = ap.inv_ti[i] * c[0];
      iy = ap.inv_ti[i] * c[1];
    }
    const float dx = ap.td[i] * (ex - c[2]) / ap.dt[i];
    const float dy = ap.td[i] * (ey - c[3]) / ap.dt[i];
    const float ox = ap.gain[i] * (ex + ix + dx) * ap.mass[i];
    const float oy = ap.gain[i] * (ey + iy + dy) * ap.mass[i];
    c[2] = ex;
    c[3] = ey;
    fx[e] = ox;
    fy[e] = oy;
    hook[(2 * i) * B + b] = ox;
    hook[(2 * i + 1) * B + b] = oy;
  }
}

// min(x, m) as torch.clamp(x, max=m) takes it (a NaN x stays NaN)
__device__ __forceinline__ float clamp_max(float x, float m) { return x > m ? m : x; }

// fused.py BallScriptActRows (football's ball_action_script), op for op: per
// wall 1 - min(distance, dist_thres) / dist_thres, the vertical factor
// 1 - min(|vy|, vel_thres) / vel_thres, the impulse ((left - right) * vv *
// impulse, (lower - upper) * vv * impulse) with its x set to 0 inside the
// goal mouth, from the ball's rows after the action override. It replaces
// the ball's force rows and goes to the hook rows (row stride B).
__device__ __forceinline__ void ball_act(const BallScriptParams& p, const float* px, const float* py,
                                         const float* vy, float* fx, float* fy, float* hook, int B, int b) {
  const int e = p.slot;
  const float pos_x = px[e], pos_y = py[e], vel_y = vy[e];
  const float dt = p.dist_thres;
  const float upper = 1.f - clamp_max(p.pw_half - pos_y, dt) / dt;
  const float lower = 1.f - clamp_max(p.pw_half + pos_y, dt) / dt;
  const float right = 1.f - clamp_max(p.pl_half - pos_x, dt) / dt;
  const float left = 1.f - clamp_max(p.pl_half + pos_x, dt) / dt;
  const float vv = 1.f - clamp_max(fabsf(vel_y), p.vel_thres) / p.vel_thres;
  float ax = (left - right) * vv * p.impulse;
  const float ay = (lower - upper) * vv * p.impulse;
  if ((pos_y < p.y_goal) && (pos_y > -p.y_goal)) ax = 0.f;
  fx[e] = ax;
  fy[e] = ay;
  hook[b] = ax;
  hook[B + b] = ay;
}

// The scenario's in-kernel process_action of kind ap.kind (the same for
// every thread): it reads the rows after the action override, rewrites the
// force rows and writes its output rows to hook (row stride B).
__device__ __forceinline__ void run_act(const ActParams& ap, const float* px, const float* py, const float* vx,
                                        const float* vy, float* fx, float* fy, float* ctrl, float* hook, int B,
                                        int b) {
  if (ap.kind == ACT_PID) pid_act(ap, fx, fy, vx, vy, ctrl, hook, B, b);
  else if (ap.kind == ACT_BALL) ball_act(ap.ball, px, py, vy, fx, fy, hook, B, b);
}

// ---------------------------------------------------------------------------
// the physics: every substep of one env step (fused.py _physics_rows), on one
// thread (L = 1)
// ---------------------------------------------------------------------------

// table words read from device memory: an index, or a float stored by its
// bits
#define TI(i) __ldg(tab + (i))
#define TF(i) __int_as_float(__ldg(tab + (i)))

// The one-thread form: ent, the block's copy of the per-entity constants;
// jfr, the joints' fixed-rotation rows ([J, B], this env at column b); dg,
// with sp.dyn_g, the dynamic-gravity rows ([2E, B]: each entity's x, then
// y); the env's state in per-thread arrays.
__device__ __forceinline__ void physics_thread(const FusedSpec& sp, const int* __restrict__ tab,
                        const int* __restrict__ ent,
                        const float* __restrict__ jfr, const float* __restrict__ dg, int B, int b,
                        float* px, float* py, float* vx, float* vy,
                        float* rot, float* w, float* fx, float* fy, float* tq) {
  const int E = sp.E;
  const float cm = sp.cm, cf = sp.cf, sub_dt = sp.sub_dt;
  float Fx[MAX_E], Fy[MAX_E], Tq[MAX_E], C[MAX_E], S[MAX_E];
  for (int substep = 0; substep < sp.substeps; ++substep) {
    // action clamps, re-applied every substep on the persistent rows
    for (int e = 0; e < E; ++e) {
      const int fl = EI(P_FLAGS, e);
      if (fl & F_MAX_F) {
        float mf = EF(P_MAX_F, e);
        float n = sqrtf(fx[e] * fx[e] + fy[e] * fy[e]);
        if (n > mf) {
          fx[e] = fx[e] / n * mf;
          fy[e] = fy[e] / n * mf;
        }
      }
      if (fl & F_F_RANGE) {
        float fr = EF(P_F_RANGE, e);
        fx[e] = fminf(fmaxf(fx[e], -fr), fr);
        fy[e] = fminf(fmaxf(fy[e], -fr), fr);
      }
      if (fl & F_MAX_T) tq[e] = fminf(fmaxf(tq[e], -EF(P_MAX_T, e)), EF(P_MAX_T, e));
      if (fl & F_T_RANGE) tq[e] = fminf(fmaxf(tq[e], -EF(P_T_RANGE, e)), EF(P_T_RANGE, e));
    }

    // action forces open the accumulators, then friction and gravity
    for (int e = 0; e < E; ++e) {
      const int fl = EI(P_FLAGS, e);
      Fx[e] = fx[e];
      Fy[e] = fy[e];
      Tq[e] = tq[e];
      if (fl & F_LIN_FRIC) {
        float m = EF(P_MASS, e), lfm = EF(P_LFM, e);
        float speed = nrm(vx[e], vy[e]);
        bool zero = speed == 0.f;
        float den = zero ? 1.f : speed;
        float fcx = fminf(fabsf(vx[e]) / sub_dt * m, lfm);
        float fcy = fminf(fabsf(vy[e]) / sub_dt * m, lfm);
        Fx[e] = Fx[e] + (zero ? 0.f : -(vx[e] / den) * fcx);
        Fy[e] = Fy[e] + (zero ? 0.f : -(vy[e] / den) * fcy);
      }
      if (fl & F_ANG_FRIC) {
        float moi = EF(P_MOI, e), afm = EF(P_AFM, e);
        float s = fabsf(w[e]);
        float den = s == 0.f ? 1.f : s;
        float fc = fminf(s / sub_dt * moi, afm);
        Tq[e] = Tq[e] + (s == 0.f ? 0.f : -(w[e] / den) * fc);
      }
      if (sp.dyn_g) {
        // per-env gravity, in place of the static term: m * (dg + eg)
        if (fl & F_MOVABLE) {
          Fx[e] = Fx[e] + EF(P_MASS, e) * (__ldg(dg + (size_t)e * B + b) + EF(P_GSX, e));
          Fy[e] = Fy[e] + EF(P_MASS, e) * (__ldg(dg + (size_t)(E + e) * B + b) + EF(P_GSY, e));
        }
      } else if (fl & F_GRAVITY) {
        Fx[e] = Fx[e] + EF(P_GSX, e);
        Fy[e] = Fy[e] + EF(P_GSY, e);
      }
    }

    // cos and sin of each rotation a pair reads, once per substep (the
    // plain version's cs())
    for (int e = 0; e < E; ++e) {
      if (EI(P_FLAGS, e) & F_TRIG) {
        C[e] = cosf(rot[e]);
        S[e] = sinf(rot[e]);
      }
    }

    // joint constraints, in table order: the attractive plus the repulsive
    // penalty between the two anchor points, +f on a, -f on b, and their
    // torques; a rotate=False constraint adds the exponential torque that
    // holds rot_a - rot_b at its fixed rotation
#pragma unroll 1
    for (int j = 0; j < sp.J; ++j) {
      const int r = sp.o_j + 8 * j;
      const int a = TI(r), bb = TI(r + 1);
      const float aax = TF(r + 2), aay = TF(r + 3), abx = TF(r + 4), aby = TF(r + 5), dist = TF(r + 6);
      const float pjax = px[a] + aax * C[a] - aay * S[a];
      const float pjay = py[a] + aax * S[a] + aay * C[a];
      const float pjbx = px[bb] + abx * C[bb] - aby * S[bb];
      const float pjby = py[bb] + abx * S[bb] + aby * C[bb];
      float fax_att, fay_att, fax_rep, fay_rep;
      constraint_force_att(cm, sp.jf, pjax, pjay, pjbx, pjby, dist, fax_att, fay_att);
      constraint_force(cm, sp.jf, pjax, pjay, pjbx, pjby, dist, fax_rep, fay_rep);
      const float fax = fax_att + fax_rep, fay = fay_att + fay_rep;
      float ta = (pjax - px[a]) * fay - (pjay - py[a]) * fax;
      float tb = (pjbx - px[bb]) * (-fay) - (pjby - py[bb]) * (-fax);
      if (!TI(r + 7)) {
        // expf(|d|) - 1, as the reference computes it (not expm1f)
        const float delta = rot[a] - (rot[bb] + jfr[(size_t)j * B + b]);
        const float ad = fabsf(delta);
        float tqc = sp.tcf * sgn(delta) * (expf(ad) - 1.f);
        if (ad < 1e-9f) tqc = 0.f;
        ta = ta + (-tqc);
        tb = tb + tqc;
      }
      Fx[a] = Fx[a] + fax;
      Fy[a] = Fy[a] + fay;
      Tq[a] = Tq[a] + ta;
      Fx[bb] = Fx[bb] + (-fax);
      Fy[bb] = Fy[bb] + (-fay);
      Tq[bb] = Tq[bb] + tb;
    }

    // sphere-sphere pairs, in spec order: +f on a, -f on b
#pragma unroll 1
    for (int k = 0; k < sp.n_ss; ++k) {
      const int r = sp.o_ss + 3 * k;
      const int a = TI(r), b = TI(r + 1);
      float cfx, cfy;
      constraint_force(cm, cf, px[a], py[a], px[b], py[b], TF(r + 2), cfx, cfy);
      Fx[a] = Fx[a] + cfx;
      Fy[a] = Fy[a] + cfy;
      Fx[b] = Fx[b] + (-cfx);
      Fy[b] = Fy[b] + (-cfy);
    }

    // line-sphere pairs: +f on the sphere, -f and its torque on the line
#pragma unroll 1
    for (int k = 0; k < sp.n_ls; ++k) {
      const int r = sp.o_ls + 4 * k;
      const int l = TI(r), s = TI(r + 1);
      float cx, cy, sfx, sfy;
      closest_point_line(px[l], py[l], C[l], S[l], TF(r + 2), px[s], py[s], cx, cy);
      constraint_force(cm, cf, px[s], py[s], cx, cy, TF(r + 3), sfx, sfy);
      Fx[s] = Fx[s] + sfx;
      Fy[s] = Fy[s] + sfy;
      Fx[l] = Fx[l] + (-sfx);
      Fy[l] = Fy[l] + (-sfy);
      Tq[l] = Tq[l] + ((cx - px[l]) * (-sfy) - (cy - py[l]) * (-sfx));
    }

    // line-line pairs: +f on a, -f on b, torque on both
#pragma unroll 1
    for (int k = 0; k < sp.n_ll; ++k) {
      const int r = sp.o_ll + 4 * k;
      const int a = TI(r), b = TI(r + 1);
      float pax, pay, pbx, pby, afx, afy;
      closest_points_line_line(px[a], py[a], C[a], S[a], TF(r + 2),
                               px[b], py[b], C[b], S[b], TF(r + 3), pax, pay, pbx, pby);
      constraint_force(cm, cf, pax, pay, pbx, pby, LMD_F, afx, afy);
      Fx[a] = Fx[a] + afx;
      Fy[a] = Fy[a] + afy;
      Tq[a] = Tq[a] + ((pax - px[a]) * afy - (pay - py[a]) * afx);
      Fx[b] = Fx[b] + (-afx);
      Fy[b] = Fy[b] + (-afy);
      Tq[b] = Tq[b] + ((pbx - px[b]) * (-afy) - (pby - py[b]) * (-afx));
    }

    // box-sphere pairs: +f on the sphere, -f and its torque on the box; a
    // hollow box pushes from its surface point, a solid one from the inner
    // point
#pragma unroll 1
    for (int k = 0; k < sp.n_bs; ++k) {
      const int r = sp.o_bs + 6 * k;
      const int b = TI(r), s = TI(r + 1);
      float cx, cy;
      closest_point_box(px[b], py[b], C[b], S[b], TF(r + 2), TF(r + 3), px[s], py[s], cx, cy);
      float ix = cx, iy = cy, dmin = TF(r + 4);
      if (TI(r + 5)) {
        float d;
        inner_point_box(px[s], py[s], cx, cy, px[b], py[b], ix, iy, d);
        dmin = dmin + d;
      }
      float sfx, sfy;
      constraint_force(cm, cf, px[s], py[s], ix, iy, dmin, sfx, sfy);
      Fx[s] = Fx[s] + sfx;
      Fy[s] = Fy[s] + sfy;
      Fx[b] = Fx[b] + (-sfx);
      Fy[b] = Fy[b] + (-sfy);
      Tq[b] = Tq[b] + ((cx - px[b]) * (-sfy) - (cy - py[b]) * (-sfx));
    }

    // box-line pairs: +f on the box, -f on the line, torque on both
#pragma unroll 1
    for (int k = 0; k < sp.n_bl; ++k) {
      const int r = sp.o_bl + 6 * k;
      const int b = TI(r), l = TI(r + 1);
      float qbx, qby, qlx, qly;
      closest_line_box(px[b], py[b], C[b], S[b], TF(r + 2), TF(r + 3),
                       px[l], py[l], C[l], S[l], TF(r + 4), qbx, qby, qlx, qly);
      float ix = qbx, iy = qby, dmin = LMD_F;
      if (TI(r + 5)) {
        float d;
        inner_point_box(qlx, qly, qbx, qby, px[b], py[b], ix, iy, d);
        dmin = LMD_F + d;
      }
      float bfx, bfy;
      constraint_force(cm, cf, ix, iy, qlx, qly, dmin, bfx, bfy);
      Fx[b] = Fx[b] + bfx;
      Fy[b] = Fy[b] + bfy;
      Tq[b] = Tq[b] + ((qbx - px[b]) * bfy - (qby - py[b]) * bfx);
      Fx[l] = Fx[l] + (-bfx);
      Fy[l] = Fy[l] + (-bfy);
      Tq[l] = Tq[l] + ((qlx - px[l]) * (-bfy) - (qly - py[l]) * (-bfx));
    }

    // box-box pairs: +f on a, -f on b, torque on both
#pragma unroll 1
    for (int k = 0; k < sp.n_bb; ++k) {
      const int r = sp.o_bb + 8 * k;
      const int a = TI(r), b = TI(r + 1);
      float qax, qay, qbx, qby;
      bb_closest(px[a], py[a], C[a], S[a], TF(r + 2), TF(r + 3),
                 px[b], py[b], C[b], S[b], TF(r + 4), TF(r + 5), qax, qay, qbx, qby);
      float iax = qax, iay = qay, da = 0.f, ibx = qbx, iby = qby, db = 0.f;
      if (TI(r + 6)) inner_point_box(qbx, qby, qax, qay, px[a], py[a], iax, iay, da);
      if (TI(r + 7)) inner_point_box(qax, qay, qbx, qby, px[b], py[b], ibx, iby, db);
      float afx, afy;
      constraint_force(cm, cf, iax, iay, ibx, iby, da + db + LMD_F, afx, afy);
      Fx[a] = Fx[a] + afx;
      Fy[a] = Fy[a] + afy;
      Tq[a] = Tq[a] + ((qax - px[a]) * afy - (qay - py[a]) * afx);
      Fx[b] = Fx[b] + (-afx);
      Fy[b] = Fy[b] + (-afy);
      Tq[b] = Tq[b] + ((qbx - px[b]) * (-afy) - (qby - py[b]) * (-afx));
    }

    // integrate (semi-implicit Euler; drag on the first substep only).
    // Accumulators of entities that are not movable (rotatable) are never
    // read, so the pair loops above need no masks.
    for (int e = 0; e < E; ++e) {
      const int fl = EI(P_FLAGS, e);
      const bool drag = substep == 0 && (fl & F_DRAG);
      if (fl & F_MOVABLE) {
        if (drag) {
          vx[e] = vx[e] * EF(P_DRAG, e);
          vy[e] = vy[e] * EF(P_DRAG, e);
        }
        float inv_m = EF(P_INV_MASS, e);
        vx[e] = vx[e] + Fx[e] * inv_m * sub_dt;
        vy[e] = vy[e] + Fy[e] * inv_m * sub_dt;
        if (fl & F_MAX_SPEED) {
          float ms = EF(P_MAX_SPEED, e);
          float n = sqrtf(vx[e] * vx[e] + vy[e] * vy[e]);
          float sc = n > ms ? ms / n : 1.f;
          vx[e] = vx[e] * sc;
          vy[e] = vy[e] * sc;
        }
        if (fl & F_V_RANGE) {
          float vr = EF(P_V_RANGE, e);
          vx[e] = fminf(fmaxf(vx[e], -vr), vr);
          vy[e] = fminf(fmaxf(vy[e], -vr), vr);
        }
        px[e] = px[e] + vx[e] * sub_dt;
        py[e] = py[e] + vy[e] * sub_dt;
        if (sp.has_x) px[e] = fminf(fmaxf(px[e], -sp.x_semidim), sp.x_semidim);
        if (sp.has_y) py[e] = fminf(fmaxf(py[e], -sp.y_semidim), sp.y_semidim);
      }
      if (fl & F_ROTATABLE) {
        if (drag) w[e] = w[e] * EF(P_DRAG, e);
        w[e] = w[e] + Tq[e] * EF(P_INV_MOI, e) * sub_dt;
        rot[e] = rot[e] + w[e] * sub_dt;
      }
    }
  }
}

#undef TI
#undef TF

// ---------------------------------------------------------------------------
// the physics: every substep of one env step (fused.py _physics_rows), on a
// group of L lanes
// ---------------------------------------------------------------------------

// table words (the block's copy in shared memory): an index, or a float
// stored by its bits
#define TI(i) (tab[i])
#define TF(i) __int_as_float(tab[i])

// One env's group: its lane (0 .. L-1) and the mask of its lanes in the warp.
// Every lane of a group runs the same phases in the same order, and the
// phases' trip counts come from the spec alone, so each __syncwarp is
// reached by all lanes of its mask.
struct Lanes {
  int lane;
  unsigned mask;
};

// One env's rows in shared memory: the input rows as the row buffer holds
// them (9E state, J fixed rotations, then the 2E dynamic-gravity rows or the
// scratch and controller rows), the force and torque accumulators and the
// cos and sin of each F_TRIG rotation.
struct EnvRows {
  float *px, *py, *vx, *vy, *rot, *w, *fx, *fy, *tq;
  const float *jfr, *dg;
  float *Fx, *Fy, *Tq, *C, *S;
};

// Each item's contributions, one float4: the force on side 0 (side 1 takes
// its negation), the torque on side 0, the torque on side 1. Side 0 is the
// plain version's i (+f), side 1 its j (-f).
__device__ __forceinline__ void put(float4* buf, int k, float fx, float fy, float t0, float t1) {
  buf[k] = make_float4(fx, fy, t0, t1);
}

// The accumulation of one item type: the lane that owns entity e walks e's
// list for the type (KernelSpec's lane lists: for entity e and type t the
// entries tab[seg[t]] .. tab[seg[t + 1]] with seg = tab + o_lst + 8e, each
// (item << 1) | side), in item order, and adds each contribution to e's
// accumulators as the plain version's loop adds it. T0 / T1: the type has a
// torque on side 0 / side 1.
template <int L, bool T0, bool T1>
__device__ __forceinline__ void accumulate(const int* __restrict__ tab, int o_lst, int t, int E, Lanes ln,
                                           const float4* buf, EnvRows& s) {
#pragma unroll 1
  for (int e = ln.lane; e < E; e += L) {
    const int* seg = tab + o_lst + 8 * e + t;
    const int lo = seg[0], hi = seg[1];
    if (lo == hi) continue;
    float ax = s.Fx[e], ay = s.Fy[e], at = s.Tq[e];
#pragma unroll 1
    for (int i = lo; i < hi; ++i) {
      const int en = tab[i];
      const float4 c = buf[en >> 1];
      if (en & 1) {
        ax = ax + (-c.x);
        ay = ay + (-c.y);
        if (T1) at = at + c.w;
      } else {
        ax = ax + c.x;
        ay = ay + c.y;
        if (T0) at = at + c.z;
      }
    }
    s.Fx[e] = ax;
    s.Fy[e] = ay;
    s.Tq[e] = at;
  }
}

template <int L>
__device__ __forceinline__ void physics(const FusedSpec& sp, const int* __restrict__ tab, Lanes ln, float4* buf,
                                        EnvRows& s) {
  const int E = sp.E;
  const int* ent = tab + sp.o_ent;
  const float cm = sp.cm, cf = sp.cf, sub_dt = sp.sub_dt;
  const int lane = ln.lane;
  float *px = s.px, *py = s.py, *vx = s.vx, *vy = s.vy, *rot = s.rot, *w = s.w;
  float *Fx = s.Fx, *Fy = s.Fy, *Tq = s.Tq, *C = s.C, *S = s.S;
#pragma unroll 1
  for (int substep = 0; substep < sp.substeps; ++substep) {
    // each entity's own phase on its lane: the action clamps (re-applied
    // every substep on the persistent rows), the action forces open the
    // accumulators, then friction and gravity; the cos and sin of each
    // rotation a pair reads (the plain version's cs())
#pragma unroll 1
    for (int e = lane; e < E; e += L) {
      const int fl = EI(P_FLAGS, e);
      float fxe = s.fx[e], fye = s.fy[e], tqe = s.tq[e];
      if (fl & F_MAX_F) {
        float mf = EF(P_MAX_F, e);
        float n = sqrtf(fxe * fxe + fye * fye);
        if (n > mf) {
          fxe = fxe / n * mf;
          fye = fye / n * mf;
        }
      }
      if (fl & F_F_RANGE) {
        float fr = EF(P_F_RANGE, e);
        fxe = fminf(fmaxf(fxe, -fr), fr);
        fye = fminf(fmaxf(fye, -fr), fr);
      }
      if (fl & F_MAX_T) tqe = fminf(fmaxf(tqe, -EF(P_MAX_T, e)), EF(P_MAX_T, e));
      if (fl & F_T_RANGE) tqe = fminf(fmaxf(tqe, -EF(P_T_RANGE, e)), EF(P_T_RANGE, e));
      s.fx[e] = fxe;
      s.fy[e] = fye;
      s.tq[e] = tqe;

      float ax = fxe, ay = fye, at = tqe;
      const float vxe = vx[e], vye = vy[e];
      if (fl & F_LIN_FRIC) {
        float m = EF(P_MASS, e), lfm = EF(P_LFM, e);
        float speed = nrm(vxe, vye);
        bool zero = speed == 0.f;
        float den = zero ? 1.f : speed;
        float fcx = fminf(fabsf(vxe) / sub_dt * m, lfm);
        float fcy = fminf(fabsf(vye) / sub_dt * m, lfm);
        ax = ax + (zero ? 0.f : -(vxe / den) * fcx);
        ay = ay + (zero ? 0.f : -(vye / den) * fcy);
      }
      if (fl & F_ANG_FRIC) {
        float moi = EF(P_MOI, e), afm = EF(P_AFM, e);
        float sw = fabsf(w[e]);
        float den = sw == 0.f ? 1.f : sw;
        float fc = fminf(sw / sub_dt * moi, afm);
        at = at + (sw == 0.f ? 0.f : -(w[e] / den) * fc);
      }
      if (sp.dyn_g) {
        // per-env gravity, in place of the static term: m * (dg + eg)
        if (fl & F_MOVABLE) {
          ax = ax + EF(P_MASS, e) * (s.dg[e] + EF(P_GSX, e));
          ay = ay + EF(P_MASS, e) * (s.dg[E + e] + EF(P_GSY, e));
        }
      } else if (fl & F_GRAVITY) {
        ax = ax + EF(P_GSX, e);
        ay = ay + EF(P_GSY, e);
      }
      Fx[e] = ax;
      Fy[e] = ay;
      Tq[e] = at;
      if (fl & F_TRIG) {
        C[e] = cosf(rot[e]);
        S[e] = sinf(rot[e]);
      }
    }
    __syncwarp(ln.mask);

    // joint constraints, lane k on constraints k, k + L, ...: the
    // attractive plus the repulsive penalty between the two anchor points,
    // +f on a, -f on b, and their torques; a rotate=False constraint adds
    // the exponential torque that holds rot_a - rot_b at its fixed rotation
    if (sp.J) {
#pragma unroll 1
      for (int j = lane; j < sp.J; j += L) {
        const int r = sp.o_j + 8 * j;
        const int a = TI(r), bb = TI(r + 1);
        const float aax = TF(r + 2), aay = TF(r + 3), abx = TF(r + 4), aby = TF(r + 5), dist = TF(r + 6);
        const float pjax = px[a] + aax * C[a] - aay * S[a];
        const float pjay = py[a] + aax * S[a] + aay * C[a];
        const float pjbx = px[bb] + abx * C[bb] - aby * S[bb];
        const float pjby = py[bb] + abx * S[bb] + aby * C[bb];
        float fax_att, fay_att, fax_rep, fay_rep;
        constraint_force_att(cm, sp.jf, pjax, pjay, pjbx, pjby, dist, fax_att, fay_att);
        constraint_force(cm, sp.jf, pjax, pjay, pjbx, pjby, dist, fax_rep, fay_rep);
        const float fax = fax_att + fax_rep, fay = fay_att + fay_rep;
        float ta = (pjax - px[a]) * fay - (pjay - py[a]) * fax;
        float tb = (pjbx - px[bb]) * (-fay) - (pjby - py[bb]) * (-fax);
        if (!TI(r + 7)) {
          // expf(|d|) - 1, as the reference computes it (not expm1f)
          const float delta = rot[a] - (rot[bb] + s.jfr[j]);
          const float ad = fabsf(delta);
          float tqc = sp.tcf * sgn(delta) * (expf(ad) - 1.f);
          if (ad < 1e-9f) tqc = 0.f;
          ta = ta + (-tqc);
          tb = tb + tqc;
        }
        put(buf, j, fax, fay, ta, tb);
      }
      __syncwarp(ln.mask);
      accumulate<L, true, true>(tab, sp.o_lst, 0, E, ln, buf, s);
      __syncwarp(ln.mask);
    }

    // sphere-sphere pairs: +f on a, -f on b
    if (sp.n_ss) {
#pragma unroll 1
      for (int k = lane; k < sp.n_ss; k += L) {
        const int r = sp.o_ss + 3 * k;
        const int a = TI(r), b = TI(r + 1);
        float cfx, cfy;
        constraint_force(cm, cf, px[a], py[a], px[b], py[b], TF(r + 2), cfx, cfy);
        put(buf, k, cfx, cfy, 0.f, 0.f);
      }
      __syncwarp(ln.mask);
      accumulate<L, false, false>(tab, sp.o_lst, 1, E, ln, buf, s);
      __syncwarp(ln.mask);
    }

    // line-sphere pairs: +f on the sphere, -f and its torque on the line
    if (sp.n_ls) {
#pragma unroll 1
      for (int k = lane; k < sp.n_ls; k += L) {
        const int r = sp.o_ls + 4 * k;
        const int l = TI(r), sph = TI(r + 1);
        float cx, cy, sfx, sfy;
        closest_point_line(px[l], py[l], C[l], S[l], TF(r + 2), px[sph], py[sph], cx, cy);
        constraint_force(cm, cf, px[sph], py[sph], cx, cy, TF(r + 3), sfx, sfy);
        put(buf, k, sfx, sfy, 0.f, (cx - px[l]) * (-sfy) - (cy - py[l]) * (-sfx));
      }
      __syncwarp(ln.mask);
      accumulate<L, false, true>(tab, sp.o_lst, 2, E, ln, buf, s);
      __syncwarp(ln.mask);
    }

    // line-line pairs: +f on a, -f on b, torque on both
    if (sp.n_ll) {
#pragma unroll 1
      for (int k = lane; k < sp.n_ll; k += L) {
        const int r = sp.o_ll + 4 * k;
        const int a = TI(r), b = TI(r + 1);
        float pax, pay, pbx, pby, afx, afy;
        closest_points_line_line(px[a], py[a], C[a], S[a], TF(r + 2),
                                 px[b], py[b], C[b], S[b], TF(r + 3), pax, pay, pbx, pby);
        constraint_force(cm, cf, pax, pay, pbx, pby, LMD_F, afx, afy);
        put(buf, k, afx, afy, (pax - px[a]) * afy - (pay - py[a]) * afx,
            (pbx - px[b]) * (-afy) - (pby - py[b]) * (-afx));
      }
      __syncwarp(ln.mask);
      accumulate<L, true, true>(tab, sp.o_lst, 3, E, ln, buf, s);
      __syncwarp(ln.mask);
    }

    // box-sphere pairs: +f on the sphere, -f and its torque on the box; a
    // hollow box pushes from its surface point, a solid one from the inner
    // point
    if (sp.n_bs) {
#pragma unroll 1
      for (int k = lane; k < sp.n_bs; k += L) {
        const int r = sp.o_bs + 6 * k;
        const int b = TI(r), sph = TI(r + 1);
        float cx, cy;
        closest_point_box(px[b], py[b], C[b], S[b], TF(r + 2), TF(r + 3), px[sph], py[sph], cx, cy);
        float ix = cx, iy = cy, dmin = TF(r + 4);
        if (TI(r + 5)) {
          float d;
          inner_point_box(px[sph], py[sph], cx, cy, px[b], py[b], ix, iy, d);
          dmin = dmin + d;
        }
        float sfx, sfy;
        constraint_force(cm, cf, px[sph], py[sph], ix, iy, dmin, sfx, sfy);
        put(buf, k, sfx, sfy, 0.f, (cx - px[b]) * (-sfy) - (cy - py[b]) * (-sfx));
      }
      __syncwarp(ln.mask);
      accumulate<L, false, true>(tab, sp.o_lst, 4, E, ln, buf, s);
      __syncwarp(ln.mask);
    }

    // box-line pairs: +f on the box, -f on the line, torque on both
    if (sp.n_bl) {
#pragma unroll 1
      for (int k = lane; k < sp.n_bl; k += L) {
        const int r = sp.o_bl + 6 * k;
        const int b = TI(r), l = TI(r + 1);
        float qbx, qby, qlx, qly;
        closest_line_box(px[b], py[b], C[b], S[b], TF(r + 2), TF(r + 3),
                         px[l], py[l], C[l], S[l], TF(r + 4), qbx, qby, qlx, qly);
        float ix = qbx, iy = qby, dmin = LMD_F;
        if (TI(r + 5)) {
          float d;
          inner_point_box(qlx, qly, qbx, qby, px[b], py[b], ix, iy, d);
          dmin = LMD_F + d;
        }
        float bfx, bfy;
        constraint_force(cm, cf, ix, iy, qlx, qly, dmin, bfx, bfy);
        put(buf, k, bfx, bfy, (qbx - px[b]) * bfy - (qby - py[b]) * bfx,
            (qlx - px[l]) * (-bfy) - (qly - py[l]) * (-bfx));
      }
      __syncwarp(ln.mask);
      accumulate<L, true, true>(tab, sp.o_lst, 5, E, ln, buf, s);
      __syncwarp(ln.mask);
    }

    // box-box pairs: +f on a, -f on b, torque on both
    if (sp.n_bb) {
#pragma unroll 1
      for (int k = lane; k < sp.n_bb; k += L) {
        const int r = sp.o_bb + 8 * k;
        const int a = TI(r), b = TI(r + 1);
        float qax, qay, qbx, qby;
        bb_closest(px[a], py[a], C[a], S[a], TF(r + 2), TF(r + 3),
                   px[b], py[b], C[b], S[b], TF(r + 4), TF(r + 5), qax, qay, qbx, qby);
        float iax = qax, iay = qay, da = 0.f, ibx = qbx, iby = qby, db = 0.f;
        if (TI(r + 6)) inner_point_box(qbx, qby, qax, qay, px[a], py[a], iax, iay, da);
        if (TI(r + 7)) inner_point_box(qax, qay, qbx, qby, px[b], py[b], ibx, iby, db);
        float afx, afy;
        constraint_force(cm, cf, iax, iay, ibx, iby, da + db + LMD_F, afx, afy);
        put(buf, k, afx, afy, (qax - px[a]) * afy - (qay - py[a]) * afx,
            (qbx - px[b]) * (-afy) - (qby - py[b]) * (-afx));
      }
      __syncwarp(ln.mask);
      accumulate<L, true, true>(tab, sp.o_lst, 6, E, ln, buf, s);
      __syncwarp(ln.mask);
    }

    // integrate each entity on the lane that owns it (semi-implicit Euler;
    // drag on the first substep only). Accumulators of entities that are not
    // movable (rotatable) are never read, so they need no masks.
#pragma unroll 1
    for (int e = lane; e < E; e += L) {
      const int fl = EI(P_FLAGS, e);
      const bool drag = substep == 0 && (fl & F_DRAG);
      if (fl & F_MOVABLE) {
        float vxe = vx[e], vye = vy[e];
        if (drag) {
          vxe = vxe * EF(P_DRAG, e);
          vye = vye * EF(P_DRAG, e);
        }
        float inv_m = EF(P_INV_MASS, e);
        vxe = vxe + Fx[e] * inv_m * sub_dt;
        vye = vye + Fy[e] * inv_m * sub_dt;
        if (fl & F_MAX_SPEED) {
          float ms = EF(P_MAX_SPEED, e);
          float n = sqrtf(vxe * vxe + vye * vye);
          float sc = n > ms ? ms / n : 1.f;
          vxe = vxe * sc;
          vye = vye * sc;
        }
        if (fl & F_V_RANGE) {
          float vr = EF(P_V_RANGE, e);
          vxe = fminf(fmaxf(vxe, -vr), vr);
          vye = fminf(fmaxf(vye, -vr), vr);
        }
        float pxe = px[e] + vxe * sub_dt;
        float pye = py[e] + vye * sub_dt;
        if (sp.has_x) pxe = fminf(fmaxf(pxe, -sp.x_semidim), sp.x_semidim);
        if (sp.has_y) pye = fminf(fmaxf(pye, -sp.y_semidim), sp.y_semidim);
        vx[e] = vxe;
        vy[e] = vye;
        px[e] = pxe;
        py[e] = pye;
      }
      if (fl & F_ROTATABLE) {
        float we = w[e];
        if (drag) we = we * EF(P_DRAG, e);
        we = we + Tq[e] * EF(P_INV_MOI, e) * sub_dt;
        w[e] = we;
        rot[e] = rot[e] + we * sub_dt;
      }
    }
    __syncwarp(ln.mask);
  }
}

// ---------------------------------------------------------------------------
// scenario emits (FusedOutputs.emit realized on the device)
// ---------------------------------------------------------------------------

struct NoEmit {
  __device__ __forceinline__ static void emit(const EmitParams&, const float*, const float*, const float*,
                              const float*, const float*, const float*, const float*, float*, int,
                              int) {}
};

// vmas_tpu/scenarios/transport.py TransportOutputs.emit, row for row:
// per agent [px, py, vx, vy, then per package (pkg - goal, pkg - agent,
// pkg vel, on_goal)], then the reward row, the on_goal rows and the new
// shaping rows. n_out = A * (4 + 7P) + 1 + 2P.
struct TransportEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float* rot, const float*,
                              const float* scratch, float* o, int B, int b) {
    const TransportParams& p = ep.transport;
    const int A = p.n_agents, P = p.n_pkgs;
    const float gx = px[p.goal], gy = py[p.goal];
    float og[MAX_P], shaping[MAX_P];
    float rew = 0.f;
    for (int k = 0; k < P; ++k) {
      int pi = p.pkg[k];
      float dist = nrm(px[pi] - gx, py[pi] - gy);
      float c = cosf(rot[pi]), s = sinf(rot[pi]);
      float cx, cy;
      closest_point_box(px[pi], py[pi], c, s, p.hw[k], p.hl[k], gx, gy, cx, cy);
      float d_sphere_closest = nrm(gx - cx, gy - cy);
      float d_closest_box = nrm(px[pi] - cx, py[pi] - cy);
      bool on = (dist < d_closest_box) || (d_sphere_closest < p.og_dmin);
      shaping[k] = dist * p.factor;
      float contrib = on ? 0.f : scratch[k] - shaping[k];
      rew = k == 0 ? contrib : rew + contrib;
      og[k] = on ? 1.f : 0.f;
    }
    int r = 0;
    for (int i = 0; i < A; ++i) {
      int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      for (int k = 0; k < P; ++k) {
        int pi = p.pkg[k];
        o[(r++) * B + b] = px[pi] - gx;
        o[(r++) * B + b] = py[pi] - gy;
        o[(r++) * B + b] = px[pi] - px[ai];
        o[(r++) * B + b] = py[pi] - py[ai];
        o[(r++) * B + b] = vx[pi];
        o[(r++) * B + b] = vy[pi];
        o[(r++) * B + b] = og[k];
      }
    }
    o[(r++) * B + b] = rew;
    for (int k = 0; k < P; ++k) o[(r++) * B + b] = og[k];
    for (int k = 0; k < P; ++k) o[(r++) * B + b] = shaping[k];
  }
};

// vmas_tpu/scenarios/balance.py BalanceOutputs.emit, row for row: per agent
// [pos, vel, pos - package, pos - line], then [package - goal, package vel,
// line vel, line angular velocity, line rotation mod pi], then pos_rew,
// ground_rew, on_ground, done and the new shaping. n_out = 8A + 8 + 5.
struct BalanceEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float* rot, const float* w,
                              const float* scratch, float* o, int B, int b) {
    const BalanceParams& p = ep.balance;
    const int fi = p.floor, pi = p.pkg, li = p.line, gi = p.goal;
    const float fx = px[fi], fy = py[fi];
    const float fc = cosf(rot[fi]), fs = sinf(rot[fi]);
    // line-floor overlap: box-line distance < 0
    float bx, by, lx, ly;
    closest_line_box(fx, fy, fc, fs, p.floor_hw, p.floor_hl, px[li], py[li], cosf(rot[li]), sinf(rot[li]),
                     p.line_half, bx, by, lx, ly);
    const bool line_floor = nrm(bx - lx, by - ly) - LMD_F < 0.f;
    // package-floor overlap: the box-sphere overlap test
    float cx, cy;
    closest_point_box(fx, fy, fc, fs, p.floor_hw, p.floor_hl, px[pi], py[pi], cx, cy);
    const float d_sphere_closest = nrm(px[pi] - cx, py[pi] - cy);
    const float d_sphere_box = nrm(px[pi] - fx, py[pi] - fy);
    const float d_closest_box = nrm(fx - cx, fy - cy);
    const bool pkg_floor = (d_sphere_box < d_closest_box) || (d_sphere_closest < p.pkg_dmin);
    const bool on_ground = line_floor || pkg_floor;

    const float dgx = px[pi] - px[gi], dgy = py[pi] - py[gi];
    const float package_dist = nrm(dgx, dgy);
    const float shaping = package_dist * p.factor;
    const float pos_rew = scratch[0] - shaping;
    const float ground_rew = on_ground ? p.fall_rew : 0.f;
    // package-goal overlap: sphere-sphere distance < 0
    const bool pkg_goal = package_dist - p.pkg_r - p.goal_r < 0.f;
    const bool done = on_ground || pkg_goal;
    // jnp.mod / torch.remainder: fmod, then the divisor's sign
    float rmod = fmodf(rot[li], PI_F);
    if (rmod != 0.f && (rmod < 0.f) != (PI_F < 0.f)) rmod = rmod + PI_F;

    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = px[ai] - px[pi];
      o[(r++) * B + b] = py[ai] - py[pi];
      o[(r++) * B + b] = px[ai] - px[li];
      o[(r++) * B + b] = py[ai] - py[li];
    }
    o[(r++) * B + b] = dgx;
    o[(r++) * B + b] = dgy;
    o[(r++) * B + b] = vx[pi];
    o[(r++) * B + b] = vy[pi];
    o[(r++) * B + b] = vx[li];
    o[(r++) * B + b] = vy[li];
    o[(r++) * B + b] = w[li];
    o[(r++) * B + b] = rmod;
    o[(r++) * B + b] = pos_rew;
    o[(r++) * B + b] = ground_rew;
    o[(r++) * B + b] = on_ground ? 1.f : 0.f;
    o[(r++) * B + b] = done ? 1.f : 0.f;
    o[(r++) * B + b] = shaping;
  }
};

// |a - b| on angles mod pi, the nearer way round (joint_passage.py
// get_line_angle_dist_0_180)
__device__ __forceinline__ float angle_dist(float a, float b) {
  a = mod_pi(a);
  b = mod_pi(b);
  return fminf(fabsf(a - b), fminf(fabsf(a - (b - PI_F)), fabsf((a - PI_F) - b)));
}

// vmas_tpu/scenarios/joint_passage.py JointPassageOutputs.emit, row for row:
// per agent [pos, vel, pos - goal, pos - each open passage, the goal's
// direction (cos, sin), the joint's rotation if observed], then rew,
// pos_rew, rot_rew, the four new shapings, passed, just_passed and done.
// Scratch in: pos_shaping_pre, pos_shaping_post, rot_shaping_pre,
// rot_shaping_post, passed.
struct JointPassageEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float* rot, const float*,
                              const float* scratch, float* o, int B, int b) {
    const JointPassageParams& p = ep.joint_passage;
    const int jl = p.jl, gi = p.goal;
    const bool joint_passed = py[jl] > 0.f;
    bool all_passed = true;
    for (int i = 0; i < p.n_agents; ++i) all_passed = all_passed && (py[p.agent[i]] > p.pw_half);
    float dist_pass = 0.f;
    for (int k = 0; k < p.n_open; ++k) {
      const float d = nrm(px[jl] - px[p.open[k]], py[jl] - py[p.open[k]]);
      dist_pass = k == 0 ? d : fminf(dist_pass, d);
    }
    const float pp_pre = dist_pass * p.pos_f;
    float pos_rew = !joint_passed ? scratch[0] - pp_pre : 0.f;
    const float dist_goal = nrm(px[jl] - px[gi], py[jl] - py[gi]);
    const float pp_post = dist_goal * p.pos_f;
    pos_rew = pos_rew + (joint_passed ? scratch[1] - pp_post : 0.f);
    const bool rot_passed = p.all_rot ? all_passed : joint_passed;
    const float rp_pre = angle_dist(rot[jl], p.middle) * p.rot_f;
    float rot_rew = !rot_passed ? scratch[2] - rp_pre : 0.f;
    const float dist_rot_goal = angle_dist(rot[jl], rot[gi]);
    const float rp_post = dist_rot_goal * p.rot_f;
    rot_rew = rot_rew + (rot_passed ? scratch[3] - rp_post : 0.f);
    const float rew = pos_rew + rot_rew;
    const bool just_passed = all_passed && (scratch[4] == 0.f);
    const float passed = just_passed ? 100.f : scratch[4];
    const bool done = (dist_goal <= 0.01f) && (dist_rot_goal <= 0.01f);
    const float gc = cosf(rot[gi]), gs = sinf(rot[gi]);

    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = px[ai] - px[gi];
      o[(r++) * B + b] = py[ai] - py[gi];
      for (int k = 0; k < p.n_open; ++k) {
        o[(r++) * B + b] = px[ai] - px[p.open[k]];
        o[(r++) * B + b] = py[ai] - py[p.open[k]];
      }
      o[(r++) * B + b] = gc;
      o[(r++) * B + b] = gs;
      if (p.obs_joint) o[(r++) * B + b] = rot[jl];
    }
    o[(r++) * B + b] = rew;
    o[(r++) * B + b] = pos_rew;
    o[(r++) * B + b] = rot_rew;
    o[(r++) * B + b] = pp_pre;
    o[(r++) * B + b] = pp_post;
    o[(r++) * B + b] = rp_pre;
    o[(r++) * B + b] = rp_post;
    o[(r++) * B + b] = passed;
    o[(r++) * B + b] = just_passed ? 1.f : 0.f;
    o[(r++) * B + b] = done ? 1.f : 0.f;
  }
};

// vmas_tpu/scenarios/debug/waterfall.py WaterfallOutputs.emit, row for row:
// per agent [pos, vel, each landmark's pos - the agent's], then per agent
// the reward, minus its distance to the goal (the floor).
struct WaterfallEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float*, float* o, int B, int b) {
    const WaterfallParams& p = ep.waterfall;
    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      for (int k = 0; k < p.n_lm; ++k) {
        o[(r++) * B + b] = px[p.lm[k]] - px[ai];
        o[(r++) * B + b] = py[p.lm[k]] - py[ai];
      }
    }
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = -nrm(px[ai] - px[p.goal], py[ai] - py[p.goal]);
    }
  }
};

// vmas_tpu/scenarios/give_way.py GiveWayOutputs.emit, row for row: per
// agent [pos, vel, then pos - each other agent's if rel_obs], then the new
// shapings, pos_rew, final_rew and goal_reached. Scratch in: the previous
// shapings.
struct GiveWayEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float* scratch, float* o, int B, int b) {
    const GiveWayParams& p = ep.give_way;
    const int A = p.n_agents;
    float shaping[MAX_A];
    bool reached = true;
    for (int i = 0; i < A; ++i) {
      const float d = nrm(px[p.agent[i]] - px[p.goal[i]], py[p.agent[i]] - py[p.goal[i]]);
      reached = reached && (d < p.goal_r[i]);
      shaping[i] = d * p.factor;
    }
    float pos_rew = 0.f;  // Python's sum() starts at 0
    for (int i = 0; i < A; ++i) pos_rew = pos_rew + (scratch[i] - shaping[i]);
    int r = 0;
    for (int i = 0; i < A; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      if (p.rel_obs) {
        for (int j = 0; j < A; ++j) {
          if (j == i) continue;
          o[(r++) * B + b] = px[ai] - px[p.agent[j]];
          o[(r++) * B + b] = py[ai] - py[p.agent[j]];
        }
      }
    }
    for (int i = 0; i < A; ++i) o[(r++) * B + b] = shaping[i];
    o[(r++) * B + b] = pos_rew;
    o[(r++) * B + b] = reached ? p.final : 0.f;
    o[(r++) * B + b] = reached ? 1.f : 0.f;
  }
};

// vmas_tpu/scenarios/multi_give_way.py MultiGiveWayOutputs.emit, row for
// row: per agent [pos, vel, pos - goal, its norm], then the per-agent
// position rewards, the pairwise collision penalties (norm - 2r <= min_coll,
// each pair with another agent in agent order), the new shapings,
// final_rew and the reached_goal latch. Scratch in: the previous shapings,
// then reached_goal.
struct MultiGiveWayEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float* scratch, float* o, int B, int b) {
    const MultiGiveWayParams& p = ep.multi_give_way;
    const int A = p.n_agents;
    float gx[MAX_A], gy[MAX_A], dist[MAX_A];
    bool all_reached = true;
    for (int i = 0; i < A; ++i) {
      gx[i] = px[p.agent[i]] - px[p.goal[i]];
      gy[i] = py[p.agent[i]] - py[p.goal[i]];
      dist[i] = nrm(gx[i], gy[i]);
      all_reached = all_reached && (dist[i] < p.goal_r[i]);
    }
    const bool reached_new = (scratch[A] > 0.5f) || all_reached;
    int r = 0;
    for (int i = 0; i < A; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = gx[i];
      o[(r++) * B + b] = gy[i];
      o[(r++) * B + b] = dist[i];
    }
    for (int i = 0; i < A; ++i)
      o[(r++) * B + b] = p.factor_zero ? -dist[i] * 1e-4f : scratch[i] - dist[i] * p.factor;
    for (int i = 0; i < A; ++i) {
      const int ai = p.agent[i];
      float c = 0.f;
      bool first = true;
      for (int j = 0; j < A; ++j) {
        if (j == i) continue;
        const int aj = p.agent[j];
        const float d = nrm(px[ai] - px[aj], py[ai] - py[aj]) - p.two_r;
        const float hit = (d <= p.min_coll ? 1.f : 0.f) * p.coll_pen;
        c = first ? hit : c + hit;
        first = false;
      }
      o[(r++) * B + b] = c;
    }
    for (int i = 0; i < A; ++i) o[(r++) * B + b] = dist[i] * p.factor;
    o[(r++) * B + b] = all_reached ? p.final : 0.f;
    o[(r++) * B + b] = reached_new ? 1.f : 0.f;
  }
};

// vmas_tpu/scenarios/mpe/simple.py SimpleOutputs.emit, row for row: per
// agent [vel, each landmark's pos - the agent's], then per agent the reward,
// minus the squared distance to landmark 0.
struct SimpleEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float*, float* o, int B, int b) {
    const SimpleParams& p = ep.simple;
    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.a0 + i;
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      for (int k = 0; k < p.n_lm; ++k) {
        o[(r++) * B + b] = px[p.l0 + k] - px[ai];
        o[(r++) * B + b] = py[p.l0 + k] - py[ai];
      }
    }
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.a0 + i;
      const float dx = px[ai] - px[p.l0], dy = py[ai] - py[p.l0];
      o[(r++) * B + b] = -(dx * dx + dy * dy);
    }
  }
};

// vmas_tpu/scenarios/mpe/simple_spread.py SimpleSpreadOutputs.emit, row for
// row: per agent [pos, vel, each landmark's pos - the agent's, then each
// other agent's if obs_others], then the shared reward: minus the sum over
// landmarks of the nearest agent's distance, times the number of agents,
// minus one per ordered pair of overlapping agents.
struct SimpleSpreadEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float*, float* o, int B, int b) {
    const SimpleSpreadParams& p = ep.simple_spread;
    const int A = p.n_agents;
    float closest_sum = 0.f;
    for (int k = 0; k < p.n_lm; ++k) {
      const int li = p.l0 + k;
      float closest = 0.f;
      for (int i = 0; i < A; ++i) {
        const float d = nrm(px[p.a0 + i] - px[li], py[p.a0 + i] - py[li]);
        closest = i == 0 ? d : fminf(closest, d);
      }
      closest_sum = k == 0 ? closest : closest_sum + closest;
    }
    float rew = -closest_sum * (float)A;
    for (int i = 0; i < A; ++i) {
      for (int j = 0; j < A; ++j) {
        if (i == j) continue;
        const float d = nrm(px[p.a0 + i] - px[p.a0 + j], py[p.a0 + i] - py[p.a0 + j]);
        rew = rew - (d - p.radius[i] - p.radius[j] < 0.f ? 1.f : 0.f);
      }
    }
    int r = 0;
    for (int i = 0; i < A; ++i) {
      const int ai = p.a0 + i;
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      for (int k = 0; k < p.n_lm; ++k) {
        o[(r++) * B + b] = px[p.l0 + k] - px[ai];
        o[(r++) * B + b] = py[p.l0 + k] - py[ai];
      }
      if (p.obs_others) {
        for (int j = 0; j < A; ++j) {
          if (j == i) continue;
          o[(r++) * B + b] = px[p.a0 + j] - px[ai];
          o[(r++) * B + b] = py[p.a0 + j] - py[ai];
        }
      }
    }
    o[(r++) * B + b] = rew;
  }
};

// fused.py _one_hot_select: the row of landmark `idx` (a float index row
// of scratch) among landmarks l0 .. l0 + n - 1, as the sum from 0 of
// (idx == k) * row_k, which is the gathered value
__device__ __forceinline__ float one_hot_sel(float idx, const float* r, int l0, int n) {
  float acc = 0.f;
  for (int k = 0; k < n; ++k) acc = acc + (idx == (float)k ? 1.f : 0.f) * r[l0 + k];
  return acc;
}

// the rows of each other agent's pos - agent i's (i among a0 .. a0 + A - 1)
__device__ __forceinline__ void other_rels(const float* px, const float* py, int a0, int A, int i, float* o, int B,
                                           int b, int& r) {
  for (int j = 0; j < A; ++j) {
    if (j == i) continue;
    o[(r++) * B + b] = px[a0 + j] - px[a0 + i];
    o[(r++) * B + b] = py[a0 + j] - py[a0 + i];
  }
}

// the rows of each landmark's pos - agent ai's
__device__ __forceinline__ void landmark_rels(const float* px, const float* py, int l0, int n_lm, int ai, float* o,
                                              int B, int b, int& r) {
  for (int k = 0; k < n_lm; ++k) {
    o[(r++) * B + b] = px[l0 + k] - px[ai];
    o[(r++) * B + b] = py[l0 + k] - py[ai];
  }
}

// vmas_tpu/scenarios/mpe/simple_push.py SimplePushOutputs.emit, row for row:
// the goal landmark picked by the goal_idx scratch row; per agent [vel, the
// goal's pos - the agent's (good agents only), each landmark's, each other
// agent's], then per agent the reward: a good agent's minus its distance
// to the goal, an adversary's the good agents' nearest distance to the goal
// minus its own.
struct SimplePushEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float* scratch, float* o, int B, int b) {
    const MpeTeamParams& p = ep.simple_push;
    const int A = p.n_agents;
    const float gx = one_hot_sel(scratch[0], px, p.l0, p.n_lm);
    const float gy = one_hot_sel(scratch[0], py, p.l0, p.n_lm);
    int r = 0;
    for (int i = 0; i < A; ++i) {
      const int ai = p.a0 + i;
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      if (!p.adversary[i]) {
        o[(r++) * B + b] = gx - px[ai];
        o[(r++) * B + b] = gy - py[ai];
      }
      landmark_rels(px, py, p.l0, p.n_lm, ai, o, B, b, r);
      other_rels(px, py, p.a0, A, i, o, B, b, r);
    }
    for (int i = 0; i < A; ++i) {
      const int ai = p.a0 + i;
      if (p.adversary[i]) {
        float pos_rew = 0.f;
        bool first = true;
        for (int j = 0; j < A; ++j) {
          if (p.adversary[j]) continue;
          const float d = nrm(px[p.a0 + j] - gx, py[p.a0 + j] - gy);
          pos_rew = first ? d : fminf(pos_rew, d);
          first = false;
        }
        o[(r++) * B + b] = pos_rew - nrm(gx - px[ai], gy - py[ai]);
      } else {
        o[(r++) * B + b] = -nrm(px[ai] - gx, py[ai] - gy);
      }
    }
  }
};

// vmas_tpu/scenarios/mpe/simple_adversary.py SimpleAdversaryOutputs.emit,
// row for row: the goal landmark picked by the goal_idx scratch row; per
// agent [the goal's pos - the agent's (good agents only), each landmark's,
// each other agent's], then per agent the reward: an adversary's minus its
// distance to the goal, a good agent's the adversaries' summed distance
// minus the good agents' nearest.
struct SimpleAdversaryEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float*, const float*, const float*, const float*,
                              const float* scratch, float* o, int B, int b) {
    const MpeTeamParams& p = ep.simple_adversary;
    const int A = p.n_agents;
    const float gx = one_hot_sel(scratch[0], px, p.l0, p.n_lm);
    const float gy = one_hot_sel(scratch[0], py, p.l0, p.n_lm);
    int r = 0;
    for (int i = 0; i < A; ++i) {
      const int ai = p.a0 + i;
      if (!p.adversary[i]) {
        o[(r++) * B + b] = gx - px[ai];
        o[(r++) * B + b] = gy - py[ai];
      }
      landmark_rels(px, py, p.l0, p.n_lm, ai, o, B, b, r);
      other_rels(px, py, p.a0, A, i, o, B, b, r);
    }
    // Python's sum: from 0, in agent order
    float adv_sum = 0.f, good_min = 0.f;
    bool first = true;
    for (int j = 0; j < A; ++j) {
      const float d = nrm(px[p.a0 + j] - gx, py[p.a0 + j] - gy);
      if (p.adversary[j]) {
        adv_sum = adv_sum + d;
      } else {
        good_min = first ? d : fminf(good_min, d);
        first = false;
      }
    }
    for (int i = 0; i < A; ++i) {
      const int ai = p.a0 + i;
      o[(r++) * B + b] = p.adversary[i] ? -nrm(px[ai] - gx, py[ai] - gy) : -good_min + adv_sum;
    }
  }
};

// 1 where agents a and b (entity indices) are closer than thr, else 0
__device__ __forceinline__ float hit(const float* px, const float* py, int a, int b, float thr) {
  return nrm(px[a] - px[b], py[a] - py[b]) < thr ? 1.f : 0.f;
}

// vmas_tpu/scenarios/mpe/simple_tag.py SimpleTagOutputs.emit, row for row:
// per agent [vel if observed, pos if observed, each landmark's pos - the
// agent's, its position partners' pos - its own, its velocity partners'
// vel] (an adversary sees the good agents' pos and vel and, with
// same_team, the other adversaries' pos; a good agent the adversaries' pos
// and, with same_team, the other good agents' pos and vel), then per agent
// the reward: an adversary's -0.1 x its nearest good agent's distance if
// shaped, plus 10 per good agent it touches; a good agent's, per
// adversary, 0.1 x its distance if shaped and -10 if they touch; the terms
// added in that order.
struct SimpleTagEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float*, float* o, int B, int b) {
    const SimpleTagParams& p = ep.simple_tag;
    const int A = p.n_agents, a0 = p.a0;
    int r = 0;
    for (int i = 0; i < A; ++i) {
      const int ai = a0 + i;
      const bool adv = p.adversary[i];
      if (p.obs_vel) {
        o[(r++) * B + b] = vx[ai];
        o[(r++) * B + b] = vy[ai];
      }
      if (p.obs_pos) {
        o[(r++) * B + b] = px[ai];
        o[(r++) * B + b] = py[ai];
      }
      landmark_rels(px, py, p.l0, p.n_lm, ai, o, B, b, r);
      for (int j = 0; j < A; ++j) {
        if (j == i || (adv == (bool)p.adversary[j] && !p.same_team)) continue;
        o[(r++) * B + b] = px[a0 + j] - px[ai];
        o[(r++) * B + b] = py[a0 + j] - py[ai];
      }
      for (int j = 0; j < A; ++j) {
        if (j == i || p.adversary[j] || (!adv && !p.same_team)) continue;
        o[(r++) * B + b] = vx[a0 + j];
        o[(r++) * B + b] = vy[a0 + j];
      }
    }
    for (int i = 0; i < A; ++i) {
      const int ai = a0 + i;
      float rew = 0.f;
      bool any = false;
      if (p.adversary[i]) {
        if (p.shape_adv) {
          float m = 0.f;
          bool first = true;
          for (int j = 0; j < A; ++j) {
            if (p.adversary[j]) continue;
            const float d = nrm(px[a0 + j] - px[ai], py[a0 + j] - py[ai]);
            m = first ? d : fminf(m, d);
            first = false;
          }
          rew = -0.1f * m;
          any = true;
        }
        if (p.collide[i]) {
          for (int j = 0; j < A; ++j) {
            if (p.adversary[j]) continue;
            const float t = 10.f * hit(px, py, a0 + j, ai, p.hit_r[p.rcls[j] * MAX_RC + p.rcls[i]]);
            rew = any ? rew + t : t;
            any = true;
          }
        }
      } else {
        for (int j = 0; j < A; ++j) {
          if (!p.adversary[j]) continue;
          if (p.shape_agent) {
            const float t = 0.1f * nrm(px[ai] - px[a0 + j], py[ai] - py[a0 + j]);
            rew = any ? rew + t : t;
            any = true;
          }
          if (p.collide[i]) {
            const float t = -10.f * hit(px, py, a0 + j, ai, p.hit_r[p.rcls[j] * MAX_RC + p.rcls[i]]);
            rew = any ? rew + t : t;
            any = true;
          }
        }
      }
      o[(r++) * B + b] = rew;
    }
  }
};

// vmas_tpu/scenarios/mpe/simple_reference.py SimpleReferenceOutputs.emit,
// row for row: per agent [vel, each landmark's pos - the agent's], then the
// shared reward: the sum over the two agents of minus the other agent's
// distance to the landmark the agent's goal_b scratch row picks.
struct SimpleReferenceEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float* scratch, float* o, int B, int b) {
    const SimpleParams& p = ep.simple_reference;
    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.a0 + i;
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      landmark_rels(px, py, p.l0, p.n_lm, ai, o, B, b, r);
    }
    float rew = 0.f;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ga = p.a0 + 1 - i;
      const float gx = one_hot_sel(scratch[i], px, p.l0, p.n_lm);
      const float gy = one_hot_sel(scratch[i], py, p.l0, p.n_lm);
      const float d = -nrm(px[ga] - gx, py[ga] - gy);
      rew = i == 0 ? d : rew + d;
    }
    o[(r++) * B + b] = rew;
  }
};

// vmas_tpu/scenarios/mpe/simple_speaker_listener.py
// SpeakerListenerOutputs.emit, row for row: the listener's [vel, each
// landmark's pos - its own], then the shared reward: minus the listener's
// distance to the goal landmark (the goal_idx scratch row) times the
// number of agents.
struct SpeakerListenerEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float* scratch, float* o, int B, int b) {
    const SpeakerListenerParams& p = ep.speaker_listener;
    const int li = p.listener;
    const float gx = one_hot_sel(scratch[0], px, p.l0, p.n_lm);
    const float gy = one_hot_sel(scratch[0], py, p.l0, p.n_lm);
    int r = 0;
    o[(r++) * B + b] = vx[li];
    o[(r++) * B + b] = vy[li];
    landmark_rels(px, py, p.l0, p.n_lm, li, o, B, b, r);
    o[(r++) * B + b] = -nrm(px[li] - gx, py[li] - gy) * (float)p.n_agents;
  }
};

// vmas_tpu/scenarios/mpe/simple_world_comm.py SimpleWorldCommOutputs.emit,
// row for row: per agent [vel, pos, each landmark's pos - the agent's, and
// for the leader each other agent's pos - its own, then each other good
// agent's vel] (unpack repeats the leader's once per forest), then per
// agent the reward: an adversary's 5 per touching (good agent, adversary)
// pair, summed over the good agents, then the adversaries; a good agent's
// -5 per adversary it touches, +2 per food item it touches, minus 0.05 x
// its nearest food item's distance.
struct SimpleWorldCommEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float*, float* o, int B, int b) {
    const SimpleWorldCommParams& p = ep.simple_world_comm;
    const int A = p.n_agents, a0 = p.a0;
    int r = 0;
    for (int i = 0; i < A; ++i) {
      const int ai = a0 + i;
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      landmark_rels(px, py, p.l0, p.n_lm, ai, o, B, b, r);
      if (p.leader[i]) {
        other_rels(px, py, a0, A, i, o, B, b, r);
        for (int j = 0; j < A; ++j) {
          if (j == i || p.adversary[j]) continue;
          o[(r++) * B + b] = vx[a0 + j];
          o[(r++) * B + b] = vy[a0 + j];
        }
      }
    }
    float adv_rew = 0.f;
    bool any = false;
    for (int g = 0; g < A; ++g) {
      if (p.adversary[g]) continue;
      for (int j = 0; j < A; ++j) {
        if (!p.adversary[j]) continue;
        const float t = 5.f * hit(px, py, a0 + g, a0 + j, p.hit_r[p.rcls[g] * MAX_RC + p.rcls[j]]);
        adv_rew = any ? adv_rew + t : t;
        any = true;
      }
    }
    for (int i = 0; i < A; ++i) {
      const int ai = a0 + i;
      if (p.adversary[i]) {
        o[(r++) * B + b] = p.collide[i] ? adv_rew : 0.f;
        continue;
      }
      float rew = 0.f;
      if (p.collide[i]) {
        for (int j = 0; j < A; ++j) {
          if (!p.adversary[j]) continue;
          rew = rew - 5.f * hit(px, py, a0 + j, ai, p.hit_r[p.rcls[j] * MAX_RC + p.rcls[i]]);
        }
      }
      for (int k = 0; k < p.n_food; ++k) rew = rew + 2.f * hit(px, py, ai, p.f0 + k, p.food_r[p.rcls[i]]);
      float m = 0.f;
      for (int k = 0; k < p.n_food; ++k) {
        const float d = nrm(px[p.f0 + k] - px[ai], py[p.f0 + k] - py[ai]);
        m = k == 0 ? d : fminf(m, d);
      }
      o[(r++) * B + b] = rew - 0.05f * m;
    }
  }
};


// vmas_tpu/scenarios/reverse_transport.py ReverseTransportOutputs.emit, row
// for row: per agent [pos, vel, package vel, package - agent, package -
// goal], then the reward, on_goal (the goal sphere overlapping the hollow
// package: the box-sphere overlap test) and the new shaping. Scratch in: the
// previous shaping.
struct ReverseTransportEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float* rot, const float*,
                              const float* scratch, float* o, int B, int b) {
    const ReverseTransportParams& p = ep.reverse_transport;
    const int pi = p.pkg;
    const float gx = px[p.goal], gy = py[p.goal];
    const float dx = px[pi] - gx, dy = py[pi] - gy;
    const float dist = nrm(dx, dy);
    float cx, cy;
    closest_point_box(px[pi], py[pi], cosf(rot[pi]), sinf(rot[pi]), p.hw, p.hl, gx, gy, cx, cy);
    const float d_sphere_closest = nrm(gx - cx, gy - cy);
    const float d_closest_box = nrm(px[pi] - cx, py[pi] - cy);
    const bool on_goal = (dist < d_closest_box) || (d_sphere_closest < p.og_dmin);
    const float shaping = dist * p.factor;
    const float rew = on_goal ? 0.f : scratch[0] - shaping;
    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = vx[pi];
      o[(r++) * B + b] = vy[pi];
      o[(r++) * B + b] = px[pi] - px[ai];
      o[(r++) * B + b] = py[pi] - py[ai];
      o[(r++) * B + b] = dx;
      o[(r++) * B + b] = dy;
    }
    o[(r++) * B + b] = rew;
    o[(r++) * B + b] = on_goal ? 1.f : 0.f;
    o[(r++) * B + b] = shaping;
  }
};

// vmas_tpu/scenarios/wheel.py WheelOutputs.emit, row for row: per agent
// [pos, vel, line - agent, each line end - agent, the line's rotation mod
// pi, its angular speed, the reward term], then the reward term |speed -
// v_des|.
struct WheelEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float* rot, const float* w,
                              const float*, float* o, int B, int b) {
    const WheelParams& p = ep.wheel;
    const int li = p.line;
    const float rl = rot[li];
    const float lx = px[li], ly = py[li];
    const float e1x = p.half * cosf(rl), e1y = p.half * sinf(rl);
    const float ang_abs = fabsf(w[li]);
    const float rew = fabsf(ang_abs - p.v_des);
    const float rmod = mod_pi(rl);
    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = lx - px[ai];
      o[(r++) * B + b] = ly - py[ai];
      o[(r++) * B + b] = e1x - px[ai];
      o[(r++) * B + b] = e1y - py[ai];
      o[(r++) * B + b] = -e1x - px[ai];
      o[(r++) * B + b] = -e1y - py[ai];
      o[(r++) * B + b] = rmod;
      o[(r++) * B + b] = ang_abs;
      o[(r++) * B + b] = rew;
    }
    o[(r++) * B + b] = rew;
  }
};

// vmas_tpu/scenarios/passage.py PassageOutputs.emit, row for row: per agent
// [pos, vel, goal - agent, each open passage - agent], then per agent the
// shaping reward, then per agent the collision penalty (-10 per other agent
// it overlaps, then -10 per wall it overlaps: the box-sphere overlap test;
// the terms in that order, the first one -10 x hit), then per agent the new
// shaping, then done (every agent within half its radius of its goal).
// Scratch in: the previous shapings.
struct PassageEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float* rot, const float*,
                              const float* scratch, float* o, int B, int b) {
    const PassageParams& p = ep.passage;
    const int A = p.n_agents;
    const int base = A * (6 + 2 * p.n_open);
    bool done = true;
    int r = 0;
    for (int i = 0; i < A; ++i) {
      const int ai = p.agent[i];
      const float gx = px[p.goal[i]] - px[ai], gy = py[p.goal[i]] - py[ai];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = gx;
      o[(r++) * B + b] = gy;
      for (int k = 0; k < p.n_open; ++k) {
        o[(r++) * B + b] = px[p.open[k]] - px[ai];
        o[(r++) * B + b] = py[p.open[k]] - py[ai];
      }
      const float dist = nrm(gx, gy);
      const float shaping = dist * p.factor;
      o[(base + i) * B + b] = scratch[i] - shaping;
      o[(base + 2 * A + i) * B + b] = shaping;
      done = done && (dist <= p.half_r);
    }
    for (int i = 0; i < A; ++i) {
      const int ai = p.agent[i];
      float pen = 0.f;
      if (p.collide[i]) {
        bool first = true;
        for (int j = 0; j < A; ++j) {
          if (j == i) continue;
          // the pair's one test, its lower agent first
          const int lo = p.agent[i < j ? i : j], hi = p.agent[i < j ? j : i];
          const float hit = nrm(px[lo] - px[hi], py[lo] - py[hi]) - p.two_r < 0.f ? 1.f : 0.f;
          pen = first ? -10.f * hit : pen - 10.f * hit;
          first = false;
        }
        for (int k = 0; k < p.n_walls; ++k) {
          const int wi = p.wall[k];
          float cx, cy;
          closest_point_box(px[wi], py[wi], cosf(rot[wi]), sinf(rot[wi]), p.hw, p.hl, px[ai], py[ai], cx, cy);
          const float d_sc = nrm(px[ai] - cx, py[ai] - cy);
          const float d_sb = nrm(px[ai] - px[wi], py[ai] - py[wi]);
          const float d_cb = nrm(px[wi] - cx, py[wi] - cy);
          const float hit = ((d_sb < d_cb) || (d_sc < p.wall_dmin)) ? 1.f : 0.f;
          pen = first ? -10.f * hit : pen - 10.f * hit;
          first = false;
        }
      }
      o[(base + A + i) * B + b] = pen;
    }
    o[(base + 3 * A) * B + b] = done ? 1.f : 0.f;
  }
};

// vmas_tpu/scenarios/dispersion.py DispersionOutputs.emit, row for row: per
// agent [pos, vel], then per agent each food item's pos - the agent's, then
// per food item just_eaten, eaten (merged) and how many agents are within
// eating range, then per agent the reward (the shared count of food just
// eaten, or each food item's share 1 / how_many where the agent is on it,
// -0.01 for none with penalise_by_time), then done (all food eaten).
// Scratch in: eaten, then just_eaten (zero at every step's entry).
struct DispersionEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float* scratch, float* o, int B, int b) {
    const DispersionParams& p = ep.dispersion;
    const int A = p.n_agents, F = p.n_food;
    const int o_just = 4 * A + 2 * A * F, o_eaten = o_just + F, o_hm = o_eaten + F, o_rew = o_hm + F;
    int r = 0;
    for (int i = 0; i < A; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
    }
    float hm[MAX_K];
    bool eaten[MAX_K], just[MAX_K];
    for (int k = 0; k < F; ++k) hm[k] = 0.f;
    for (int i = 0; i < A; ++i) {
      const int ai = p.agent[i];
      for (int k = 0; k < F; ++k) {
        const float rx = px[p.food[k]] - px[ai], ry = py[p.food[k]] - py[ai];
        o[(r++) * B + b] = rx;
        o[(r++) * B + b] = ry;
        hm[k] = hm[k] + (nrm(rx, ry) < p.eat_r[i] ? 1.f : 0.f);
      }
    }
    bool done = true;
    for (int k = 0; k < F; ++k) {
      eaten[k] = scratch[k] > 0.5f;
      just[k] = (scratch[F + k] > 0.5f) || (hm[k] > 0.f);
      const bool merged = eaten[k] || just[k];
      done = done && merged;
      o[(o_just + k) * B + b] = just[k] ? 1.f : 0.f;
      o[(o_eaten + k) * B + b] = merged ? 1.f : 0.f;
      o[(o_hm + k) * B + b] = hm[k];
    }
    for (int i = 0; i < A; ++i) {
      const int ai = p.agent[i];
      float rw = 0.f;
      for (int k = 0; k < F; ++k) {
        if (p.share) {
          rw = rw + (just[k] && !eaten[k] ? 1.f : 0.f);
        } else {
          const float eat = hm[k] > 0.f ? 1.f / (hm[k] > 0.f ? hm[k] : 1.f) : 0.f;
          const bool on = nrm(px[p.food[k]] - px[ai], py[p.food[k]] - py[ai]) < p.eat_r[i];
          const float term = on && !eaten[k] ? eat : 0.f;
          rw = k == 0 ? term : rw + term;
        }
      }
      if (p.by_time && rw == 0.f) rw = -0.01f;
      o[(o_rew + i) * B + b] = rw;
    }
    o[(o_rew + A) * B + b] = done ? 1.f : 0.f;
  }
};

// vmas_tpu/scenarios/dropout.py DropoutOutputs.emit, row for row: per agent
// [pos, vel, goal - agent], then eaten (merged), any_eaten (some agent
// within eating range of the goal) and the goal reward (1 where the goal is
// eaten for the first time). Scratch in: eaten.
struct DropoutEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float* scratch, float* o, int B, int b) {
    const DropoutParams& p = ep.dropout;
    const float gx = px[p.goal], gy = py[p.goal];
    const bool eaten_prev = scratch[0] > 0.5f;
    bool any = false;
    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      const bool hit = nrm(px[ai] - gx, py[ai] - gy) < p.eat_r[i];
      any = any || hit;
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = gx - px[ai];
      o[(r++) * B + b] = gy - py[ai];
    }
    o[(r++) * B + b] = eaten_prev || any ? 1.f : 0.f;
    o[(r++) * B + b] = any ? 1.f : 0.f;
    o[(r++) * B + b] = any && !eaten_prev ? 1.f : 0.f;
  }
};

// vmas_tpu/scenarios/debug/het_mass.py HetMassOutputs.emit, row for row: per
// agent [pos, vel], then the largest agent speed. (The fused form only:
// het_mass zeroes u's y outside the kernel, so it has no rows form.)
struct HetMassEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float*, float* o, int B, int b) {
    const HetMassParams& p = ep.het_mass;
    float ms = 0.f;
    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      const float sp = nrm(vx[ai], vy[ai]);
      ms = i == 0 ? sp : fmaxf(ms, sp);
    }
    o[(r++) * B + b] = ms;
  }
};

// vmas_tpu/scenarios/buzz_wire.py BuzzWireOutputs.emit, row for row: per
// agent [pos, vel, pos - goal], then rew, pos_rew, the collision penalty,
// the new shaping, collided and done. The penalty sums, over the
// collidables and then the lines, the line-sphere overlap test
// |p - closest| - LINE_MIN_DIST - r < 0 (two f32 subtractions, as the JAX
// package computes it) times the penalty. Scratch in: the previous shaping.
struct BuzzWireEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float* rot, const float*,
                              const float* scratch, float* o, int B, int b) {
    const BuzzWireParams& p = ep.buzz_wire;
    const int bi = p.ball, gi = p.goal;
    const float dist = nrm(px[bi] - px[gi], py[bi] - py[gi]);
    const float shaping = dist * p.factor;
    const float pos_rew = scratch[0] - shaping;
    // each line's direction, once (the tests below reuse it per collidable)
    float lc[MAX_E], ls[MAX_E];
    for (int k = 0; k < p.n_lines; ++k) {
      lc[k] = cosf(rot[p.line[k]]);
      ls[k] = sinf(rot[p.line[k]]);
    }
    float coll = 0.f;
    bool collided = false;
    for (int i = 0; i < p.n_coll; ++i) {
      const int ci = p.coll[i];
      for (int k = 0; k < p.n_lines; ++k) {
        const int li = p.line[k];
        float cx, cy;
        closest_point_line(px[li], py[li], lc[k], ls[k], p.half[k], px[ci], py[ci], cx, cy);
        const bool over = nrm(px[ci] - cx, py[ci] - cy) - LMD_F - p.coll_r[i] < 0.f;
        const float hit = (over ? 1.f : 0.f) * p.coll_pen;
        coll = (i == 0 && k == 0) ? hit : coll + hit;
        collided = collided || over;
      }
    }
    const bool done = (dist <= 0.01f) || collided;
    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = px[ai] - px[gi];
      o[(r++) * B + b] = py[ai] - py[gi];
    }
    o[(r++) * B + b] = pos_rew + coll;
    o[(r++) * B + b] = pos_rew;
    o[(r++) * B + b] = coll;
    o[(r++) * B + b] = shaping;
    o[(r++) * B + b] = collided ? 1.f : 0.f;
    o[(r++) * B + b] = done ? 1.f : 0.f;
  }
};

// vmas_tpu/scenarios/ball_trajectory.py BallTrajectoryOutputs.emit, row for
// row: per agent [pos, vel, pos - ball, pos], then the pos, speed and dist
// rewards and the three new shapings. The ball's closest point on the
// circle is unit(pos) * R (zero at the centre); the pos shaping is the
// square root of its distance to it. Scratch in: the three shapings.
struct BallTrajectoryEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float* scratch, float* o, int B, int b) {
    const BallTrajectoryParams& p = ep.ball_trajectory;
    const int bi = p.ball;
    const float bx = px[bi], by = py[bi];
    const float n = nrm(bx, by);
    const float den = n == 0.f ? 1.f : n;
    const float cx = (n == 0.f ? 0.f : bx / den) * p.R;
    const float cy = (n == 0.f ? 0.f : by / den) * p.R;
    const float pos_s = sqrtf(nrm(bx - cx, by - cy)) * p.pos_f;
    const float speed_s = fabsf(p.v_des - nrm(vx[bi], vy[bi])) * p.speed_f;
    float dist = 0.f;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      const float d = nrm(px[ai] - bx, py[ai] - by);
      dist = i == 0 ? d : dist + d;
    }
    const float dist_s = dist * p.dist_f;
    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = px[ai] - bx;
      o[(r++) * B + b] = py[ai] - by;
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
    }
    o[(r++) * B + b] = scratch[0] - pos_s;
    o[(r++) * B + b] = scratch[1] - speed_s;
    o[(r++) * B + b] = scratch[2] - dist_s;
    o[(r++) * B + b] = pos_s;
    o[(r++) * B + b] = speed_s;
    o[(r++) * B + b] = dist_s;
  }
};

// vmas_tpu/scenarios/ball_passage.py BallPassageOutputs.emit, row for row:
// per agent [pos, vel, pos - goal, pos - ball, pos - each open passage],
// then rew, pos_rew, the collision penalty, the two new shapings and done.
// The shapings are taken on the ball's side of the wall; the penalty sums,
// over the collidables and then the walls, the box-sphere overlap test
// times the penalty; done: the ball on the goal or out of the arena.
// Scratch in: pos_shaping_pre, pos_shaping_post.
struct BallPassageEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float* rot, const float*,
                              const float* scratch, float* o, int B, int b) {
    const BallPassageParams& p = ep.ball_passage;
    const int bi = p.ball, gi = p.goal;
    const bool ball_passed = py[bi] > 0.f;
    float dist_pass = 0.f;
    for (int k = 0; k < p.n_open; ++k) {
      const float d = nrm(px[bi] - px[p.open[k]], py[bi] - py[p.open[k]]);
      dist_pass = k == 0 ? d : fminf(dist_pass, d);
    }
    const float pre = dist_pass * p.factor;
    float pos_rew = !ball_passed ? scratch[0] - pre : 0.f;
    const float dist_goal = nrm(px[bi] - px[gi], py[bi] - py[gi]);
    const float post = dist_goal * p.factor;
    pos_rew = pos_rew + (ball_passed ? scratch[1] - post : 0.f);
    // each wall's direction, once (the tests below reuse it per collidable)
    float wc[MAX_E], ws[MAX_E];
    for (int k = 0; k < p.n_walls; ++k) {
      wc[k] = cosf(rot[p.wall[k]]);
      ws[k] = sinf(rot[p.wall[k]]);
    }
    float coll = 0.f;
    for (int i = 0; i < p.n_coll; ++i) {
      const int ci = p.coll[i];
      for (int k = 0; k < p.n_walls; ++k) {
        const int wi = p.wall[k];
        float cx, cy;
        closest_point_box(px[wi], py[wi], wc[k], ws[k], p.hw, p.hl, px[ci], py[ci], cx, cy);
        const float d_sc = nrm(px[ci] - cx, py[ci] - cy);
        const float d_sb = nrm(px[ci] - px[wi], py[ci] - py[wi]);
        const float d_cb = nrm(px[wi] - cx, py[wi] - cy);
        const float hit = ((d_sb < d_cb) || (d_sc < p.coll_dmin[i]) ? 1.f : 0.f) * p.coll_pen;
        coll = (i == 0 && k == 0) ? hit : coll + hit;
      }
    }
    const bool done = (dist_goal <= 0.01f) || (p.lo >= px[bi]) || (px[bi] >= p.hi) || (p.lo >= py[bi]) ||
                      (py[bi] >= p.hi);
    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = px[ai] - px[gi];
      o[(r++) * B + b] = py[ai] - py[gi];
      o[(r++) * B + b] = px[ai] - px[bi];
      o[(r++) * B + b] = py[ai] - py[bi];
      for (int k = 0; k < p.n_open; ++k) {
        o[(r++) * B + b] = px[ai] - px[p.open[k]];
        o[(r++) * B + b] = py[ai] - py[p.open[k]];
      }
    }
    o[(r++) * B + b] = pos_rew + coll;
    o[(r++) * B + b] = pos_rew;
    o[(r++) * B + b] = coll;
    o[(r++) * B + b] = pre;
    o[(r++) * B + b] = post;
    o[(r++) * B + b] = done ? 1.f : 0.f;
  }
};

// vmas_tpu/scenarios/joint_passage_size.py JointPassageSizeOutputs.emit, row
// for row: per agent [pos, vel, pos - goal, pos - the big passage, pos - the
// small passage, the goal's direction (cos, sin), the joint's rotation if
// observed], then rew, pos_rew, rot_rew, the three new shapings, passed,
// just_passed and done. Scratch in: pos_shaping_pre, pos_shaping_post,
// rot_shaping_pre, passed, the pass centre (x, y), the middle angle, the
// big passage (x, y) and the small one (x, y).
struct JointPassageSizeEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float* rot, const float*,
                              const float* scratch, float* o, int B, int b) {
    const JointPassageSizeParams& p = ep.joint_passage_size;
    const int jl = p.jl, gi = p.goal;
    const bool joint_passed = py[jl] > 0.f;
    bool all_passed = true;
    for (int i = 0; i < p.n_agents; ++i) all_passed = all_passed && (py[p.agent[i]] > p.pw_half);
    const float dist_pass = nrm(px[jl] - scratch[4], py[jl] - scratch[5]) * p.pos_f;
    float pos_rew = !joint_passed ? scratch[0] - dist_pass : 0.f;
    const float dist_goal_raw = nrm(px[jl] - px[gi], py[jl] - py[gi]);
    const float dist_goal = dist_goal_raw * p.pos_f;
    pos_rew = pos_rew + (joint_passed ? scratch[1] - dist_goal : 0.f);
    const float mid = scratch[6];
    const float rot_shaping = p.mid_180 ? angle_dist(rot[jl], mid) * p.rot_f
                                        : -(cosf(rot[jl]) * cosf(mid) + sinf(rot[jl]) * sinf(mid)) * p.rot_f;
    const float rot_rew = scratch[2] - rot_shaping;
    const bool just_passed = all_passed && (scratch[3] == 0.f);
    const float passed = just_passed ? 100.f : scratch[3];
    const bool done = (dist_goal_raw <= 0.01f) && (angle_dist(rot[jl], rot[gi]) <= 0.01f);
    const float gc = cosf(rot[gi]), gs = sinf(rot[gi]);
    int r = 0;
    for (int i = 0; i < p.n_agents; ++i) {
      const int ai = p.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      o[(r++) * B + b] = px[ai] - px[gi];
      o[(r++) * B + b] = py[ai] - py[gi];
      o[(r++) * B + b] = px[ai] - scratch[7];
      o[(r++) * B + b] = py[ai] - scratch[8];
      o[(r++) * B + b] = px[ai] - scratch[9];
      o[(r++) * B + b] = py[ai] - scratch[10];
      o[(r++) * B + b] = gc;
      o[(r++) * B + b] = gs;
      if (p.obs_joint) o[(r++) * B + b] = rot[jl];
    }
    o[(r++) * B + b] = pos_rew + rot_rew;
    o[(r++) * B + b] = pos_rew;
    o[(r++) * B + b] = rot_rew;
    o[(r++) * B + b] = dist_pass;
    o[(r++) * B + b] = dist_goal;
    o[(r++) * B + b] = rot_shaping;
    o[(r++) * B + b] = passed;
    o[(r++) * B + b] = just_passed ? 1.f : 0.f;
    o[(r++) * B + b] = done ? 1.f : 0.f;
  }
};

// vmas_tpu/scenarios/navigation.py NavigationOutputs.emit, row for row: per
// agent [pos, vel, pos - goal (each agent's goal with all_goals)], then the
// per-agent position rewards, the collision penalties (the pairs i > j in
// order, each distance minus the two radii one at a time) and the new
// shapings, then final_rew and done. Scratch in: the previous shapings.
struct NavigationEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float* scratch, float* o, int B, int b) {
    const NavigationParams& p = ep.navigation;
    const int A = p.n_agents;
    const int base = A * (4 + 2 * (p.all_goals ? A : 1));
    bool all_reached = true, done = true;
    int r = 0;
    for (int i = 0; i < A; ++i) {
      const int ai = p.agent[i];
      const float gx = px[ai] - px[p.goal[i]], gy = py[ai] - py[p.goal[i]];
      const float dist = nrm(gx, gy);
      all_reached = all_reached && (dist < p.goal_r[i]);
      done = done && (dist < p.done_r[i]);
      const float shaping = dist * p.factor;
      o[(base + i) * B + b] = scratch[i] - shaping;
      o[(base + 2 * A + i) * B + b] = shaping;
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      if (p.all_goals) {
        for (int k = 0; k < A; ++k) {
          o[(r++) * B + b] = px[ai] - px[p.goal[k]];
          o[(r++) * B + b] = py[ai] - py[p.goal[k]];
        }
      } else {
        o[(r++) * B + b] = gx;
        o[(r++) * B + b] = gy;
      }
    }
    float coll[MAX_A];
    for (int i = 0; i < A; ++i) coll[i] = 0.f;
    for (int i = 0; i < A; ++i) {
      const int ai = p.agent[i];
      for (int j = 0; j < i; ++j) {
        if (!((p.pair_mask[i] >> j) & 1u)) continue;
        const int aj = p.agent[j];
        const float d = nrm(px[ai] - px[aj], py[ai] - py[aj]) - p.done_r[i] - p.done_r[j];
        const float hit = (d <= p.min_coll ? 1.f : 0.f) * p.coll_pen;
        coll[i] = coll[i] + hit;
        coll[j] = coll[j] + hit;
      }
    }
    for (int i = 0; i < A; ++i) o[(base + A + i) * B + b] = coll[i];
    o[(base + 3 * A) * B + b] = all_reached ? p.final : 0.f;
    o[(base + 3 * A + 1) * B + b] = done ? 1.f : 0.f;
  }
};

// flocking's pairwise distance of agents i < j (positions in world order)
__device__ __forceinline__ float flock_dist(const FlockingParams& p, const float* px, const float* py, int i,
                                            int j) {
  const int a = p.all[i < j ? i : j], c = p.all[i < j ? j : i];
  return nrm(px[a] - px[c], py[a] - py[c]);
}

// vmas_tpu/scenarios/flocking.py FlockingOutputs.emit, row for row: per
// policy agent [pos, vel, pos - target], then the collision rewards (every
// pair of agents, the target's share dropped; a slot no pair reaches is 0),
// the distance rewards (the previous shaping minus the mean squared
// deviation from the desired distance to every other agent, summed from 0
// and divided by their count) and the new shapings, then the clock plus
// one. Scratch in: the previous shapings, then the clock.
struct FlockingEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float* scratch, float* o, int B, int b) {
    const FlockingParams& p = ep.flocking;
    const int A = p.n_agents, n = p.n_all;
    const int base = 6 * A;
    float coll[MAX_A];
    bool has[MAX_A];
    for (int s = 0; s < A; ++s) {
      coll[s] = 0.f;
      has[s] = false;
    }
    if (p.coll_rew != 0.f) {
      for (int i = 0; i < n; ++i) {
        for (int j = i + 1; j < n; ++j) {
          const float d = flock_dist(p, px, py, i, j) - p.radius[i] - p.radius[j];
          const float hit = (d <= p.min_coll ? 1.f : 0.f) * p.coll_rew;
          const int ks[2] = {i, j};
          for (int q = 0; q < 2; ++q) {
            const int s = p.slot[ks[q]];
            if (s < 0) continue;
            coll[s] = has[s] ? coll[s] + hit : hit;
            has[s] = true;
          }
        }
      }
    }
    const int ti = p.target;
    for (int s = 0; s < A; ++s) {
      const int i = p.policy[s], ai = p.all[i];
      float sum = 0.f;
      for (int j = 0; j < n; ++j) {
        if (j == i) continue;
        const float dd = flock_dist(p, px, py, i, j) - p.desired;
        sum = sum + dd * dd;
      }
      const float shaping = sum / (float)(n - 1) * p.factor;
      o[(6 * s + 0) * B + b] = px[ai];
      o[(6 * s + 1) * B + b] = py[ai];
      o[(6 * s + 2) * B + b] = vx[ai];
      o[(6 * s + 3) * B + b] = vy[ai];
      o[(6 * s + 4) * B + b] = px[ai] - px[ti];
      o[(6 * s + 5) * B + b] = py[ai] - py[ti];
      o[(base + s) * B + b] = coll[s];
      o[(base + A + s) * B + b] = scratch[s] - shaping;
      o[(base + 2 * A + s) * B + b] = shaping;
    }
    o[(base + 3 * A) * B + b] = scratch[A] + 1.f;
  }
};

// vmas_tpu/scenarios/discovery.py DiscoveryOutputs.emit, row for row: per
// agent [pos, vel], then the covering rewards (per agent the covered targets
// within its covering range, times coeff), the covered flags (at least
// per_target agents in range), the shared reward (their sum, halved where
// not 0) and, with a collision penalty, per agent the penalty times its
// count of other agents whose distance minus the two radii is below
// min_coll. Each count and sum runs from 0 in the plain version's order.
struct DiscoveryEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float*, const float*,
                              const float*, float* o, int B, int b) {
    const DiscoveryParams& p = ep.discovery;
    const int A = p.n_agents, T = p.n_targets;
    bool covered[MAX_E];
    for (int k = 0; k < T; ++k) {
      const int tk = p.target[k];
      float cnt = 0.f;
      for (int i = 0; i < A; ++i) {
        const int ai = p.agent[i];
        cnt = cnt + (nrm(px[ai] - px[tk], py[ai] - py[tk]) < p.cover_r ? 1.f : 0.f);
      }
      covered[k] = cnt >= p.per_target;
      o[(5 * A + k) * B + b] = covered[k] ? 1.f : 0.f;
    }
    float shared = 0.f;
    for (int i = 0; i < A; ++i) {
      const int ai = p.agent[i];
      o[(4 * i + 0) * B + b] = px[ai];
      o[(4 * i + 1) * B + b] = py[ai];
      o[(4 * i + 2) * B + b] = vx[ai];
      o[(4 * i + 3) * B + b] = vy[ai];
      float cnt = 0.f;
      for (int k = 0; k < T; ++k) {
        const int tk = p.target[k];
        const bool in = nrm(px[ai] - px[tk], py[ai] - py[tk]) < p.cover_r;
        cnt = cnt + (in && covered[k] ? 1.f : 0.f);
      }
      const float covering = cnt * p.coeff;
      o[(4 * A + i) * B + b] = covering;
      shared = shared + covering;
    }
    o[(5 * A + T) * B + b] = shared != 0.f ? shared / 2.f : shared;
    if (p.with_coll) {
      for (int i = 0; i < A; ++i) {
        const int ai = p.agent[i];
        float c = 0.f;
        for (int j = 0; j < A; ++j) {
          if (j == i) continue;
          const int aj = p.agent[j];
          const float d = nrm(px[ai] - px[aj], py[ai] - py[aj]) - p.radius[i] - p.radius[j];
          c = c + (d < p.min_coll ? 1.f : 0.f);
        }
        o[(5 * A + T + 1 + i) * B + b] = c * p.coll_pen;
      }
    }
  }
};

// football's dense term of one team (FootballOutputs.emit's dense): the
// ball-to-goal shaping against the goal at (gs * gx, 0), the team's agent
// nearest the ball (a running minimum in team order), and the agent shaping
// where no agent is within the trigger and the ball is at rest. Writes
// pos_rew, pos_rew_agent, the two new shapings and the distance to out5;
// returns pos_rew + pos_rew_agent.
__device__ __forceinline__ float football_dense(const FootballParams& p, const float* px, const float* py,
                                                float bpx, float bpy, float bvx, float bvy, const int* team, int n,
                                                float gs, float prev0, float prev1, float* out5) {
  const float dist_goal = nrm(bpx - gs * p.gx, bpy);
  const float pos_shaping = dist_goal * p.f_goal;
  const float pos_rew = prev0 - pos_shaping;
  float min_dist = 0.f;
  for (int i = 0; i < n; ++i) {
    const float d = nrm(px[team[i]] - bpx, py[team[i]] - bpy);
    min_dist = i == 0 ? d : fminf(min_dist, d);
  }
  const float agent_shaping = min_dist * p.f_agent;
  const bool ball_moving = nrm(bvx, bvy) > 1e-6f;
  const bool close = min_dist < p.trigger;
  const float pos_rew_agent = (close || ball_moving) ? 0.f : prev1 - agent_shaping;
  out5[0] = pos_rew;
  out5[1] = pos_rew_agent;
  out5[2] = pos_shaping;
  out5[3] = agent_shaping;
  out5[4] = min_dist;
  return pos_rew + pos_rew_agent;
}

// vmas_tpu/scenarios/football.py FootballOutputs.emit, row for row: per
// policy agent its observation (its force, pos - ball, vel - ball vel, ball
// - goal, ball vel, ball force, pos - goal, vel, then per adversary and per
// teammate pos and vel differences, its vel and its force), the red team's
// x rows negated (an exact negation: -(a - b), and -a - gx); then
// sparse_blue (the ball over a goal line by ball_size / 2 within the mouth),
// dense_blue, dense_red and done; then 5 rows per dense team. It reads the
// force rows too: its signature is its own (run_emit). Scratch in: the
// previous two shapings per dense team. One lane writes all the rows (350
// for two teams of 3).
struct FootballEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                                              const float* vx, const float* vy, const float* fx, const float* fy,
                                              const float* scratch, float* o, int B, int b) {
    const FootballParams& p = ep.football;
    const int bi = p.ball;
    const float bpx = px[bi], bpy = py[bi], bvx = vx[bi], bvy = vy[bi];
    const bool goal_mask = (bpy <= p.y_goal) && (bpy >= -p.y_goal);
    const bool blue_score = (bpx > p.x_over) && goal_mask;
    const bool red_score = (bpx < -p.x_over) && goal_mask;
    const float sparse = p.scoring * (blue_score ? 1.f : 0.f) - p.scoring * (red_score ? 1.f : 0.f);
    float dense_rows[10];
    float dense_b = 0.f, dense_r = 0.f;
    int k = 0, nd = 0;
    if (p.dense_blue) {
      dense_b = football_dense(p, px, py, bpx, bpy, bvx, bvy, p.blue_i, p.n_blue, 1.f, scratch[k], scratch[k + 1],
                               dense_rows + nd);
      k += 2;
      nd += 5;
    }
    if (p.dense_red) {
      dense_r = football_dense(p, px, py, bpx, bpy, bvx, bvy, p.red_i, p.n_red, -1.f, scratch[k], scratch[k + 1],
                               dense_rows + nd);
      nd += 5;
    }
    int r = 0;
    for (int s = 0; s < p.n_agents; ++s) {
      const int ai = p.agent[s];
      const bool blue = p.blue[s] != 0;
      const auto sx = [blue](float v) { return blue ? v : -v; };
      o[(r++) * B + b] = sx(fx[ai]);
      o[(r++) * B + b] = fy[ai];
      o[(r++) * B + b] = sx(px[ai] - bpx);
      o[(r++) * B + b] = py[ai] - bpy;
      o[(r++) * B + b] = sx(vx[ai] - bvx);
      o[(r++) * B + b] = vy[ai] - bvy;
      o[(r++) * B + b] = sx(bpx) - p.gx;
      o[(r++) * B + b] = bpy;
      o[(r++) * B + b] = sx(bvx);
      o[(r++) * B + b] = bvy;
      o[(r++) * B + b] = sx(fx[bi]);
      o[(r++) * B + b] = fy[bi];
      o[(r++) * B + b] = sx(px[ai]) - p.gx;
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = sx(vx[ai]);
      o[(r++) * B + b] = vy[ai];
      // the adversaries, then the teammates but the agent itself
      const int* other = blue ? p.red_i : p.blue_i;
      const int* team = blue ? p.blue_i : p.red_i;
      const int n_other = p.obs_adv ? (blue ? p.n_red : p.n_blue) : 0;
      const int n_team = p.obs_team ? (blue ? p.n_blue : p.n_red) : 0;
      for (int q = 0; q < n_other + n_team; ++q) {
        const int oi = q < n_other ? other[q] : team[q - n_other];
        if (oi == ai) continue;
        o[(r++) * B + b] = sx(px[ai] - px[oi]);
        o[(r++) * B + b] = py[ai] - py[oi];
        o[(r++) * B + b] = sx(vx[ai] - vx[oi]);
        o[(r++) * B + b] = vy[ai] - vy[oi];
        o[(r++) * B + b] = sx(vx[oi]);
        o[(r++) * B + b] = vy[oi];
        o[(r++) * B + b] = sx(fx[oi]);
        o[(r++) * B + b] = fy[oi];
      }
    }
    o[(r++) * B + b] = sparse;
    o[(r++) * B + b] = dense_b;
    o[(r++) * B + b] = dense_r;
    o[(r++) * B + b] = (blue_score || red_score) ? 1.f : 0.f;
    for (int q = 0; q < nd; ++q) o[(r++) * B + b] = dense_rows[q];
  }
};

// An emit's call: the emits read the entities' positions, velocities,
// rotations and angular velocities; football's reads the force rows too.
template <class Emit>
__device__ __forceinline__ void run_emit(const EmitParams& ep, const float* px, const float* py, const float* vx,
                                         const float* vy, const float* rot, const float* w, const float*,
                                         const float*, const float* scratch, float* o, int B, int b) {
  Emit::emit(ep, px, py, vx, vy, rot, w, scratch, o, B, b);
}

template <>
__device__ __forceinline__ void run_emit<FootballEmit>(const EmitParams& ep, const float* px, const float* py,
                                                       const float* vx, const float* vy, const float*,
                                                       const float*, const float* fx, const float* fy,
                                                       const float* scratch, float* o, int B, int b) {
  FootballEmit::emit(ep, px, py, vx, vy, fx, fy, scratch, o, B, b);
}

// ---------------------------------------------------------------------------
// the kernel, in both forms
// ---------------------------------------------------------------------------

#define NT 128  // threads per block

// The block's dynamic shared memory, in 4-byte words: the G groups' item
// buffers (float4, first, so they are 16-byte aligned), the G env records
// (the env's input rows, then Fx, Fy, Tq, C and S: 5E), the output rows
// [n_rows_out][G] (the emit rows, then in the rows form the hook rows), the
// rows form's action rows of one step [2 n_act][G], and the world's table.
// A record's stride is padded to L modulo 32 words, so the lanes of the
// groups that share a warp read entity e of their records from distinct
// banks.
struct Smem {
  int G, n_max, R_x, stride, o_rec, o_out, o_act, o_tab, words;
};

__host__ __device__ inline Smem smem_layout(const FusedSpec& sp, bool rows, int n_ctrl, int n_rows_out, int L) {
  Smem m;
  m.G = NT / L;
  int n_max = sp.J;
  const int ns[6] = {sp.n_ss, sp.n_ls, sp.n_ll, sp.n_bs, sp.n_bl, sp.n_bb};
  for (int t = 0; t < 6; ++t) n_max = ns[t] > n_max ? ns[t] : n_max;
  m.n_max = n_max;
  m.R_x = 9 * sp.E + sp.J + (rows ? sp.K_in + n_ctrl : 2 * sp.E * sp.dyn_g + sp.K_in);
  const int rec = m.R_x + 5 * sp.E;
  m.stride = rec + ((L - rec % 32) % 32 + 32) % 32;
  m.o_rec = 4 * m.G * n_max;
  m.o_out = m.o_rec + m.G * m.stride;
  m.o_act = m.o_out + n_rows_out * m.G;
  m.o_tab = m.o_act + (rows ? 2 * sp.n_act * m.G : 0);
  m.words = m.o_tab + sp.n_tab;
  return m;
}

// One group of L lanes per env (L = 4, 8, 16 or 32), G = NT / L envs per block (block env0 +
// g). Every thread of the block runs every phase: a group whose env lies
// beyond B computes on zero rows and stores nothing, so no barrier is
// skipped on a ragged last block.
template <bool ROWS, class Emit, int L>
__global__ void __launch_bounds__(NT)
fused_step_kernel(const FusedSpec sp, const EmitParams ep, const ActParams ap, const int* __restrict__ gtab,
                  const float* __restrict__ x, const float* __restrict__ act, float* __restrict__ out,
                  float* __restrict__ extra, int B, int k_steps, int n_rows_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int E = sp.E;
  const int n_ctrl = ROWS ? act_ctrl_rows(ap) : 0;
  const Smem m = smem_layout(sp, ROWS, n_ctrl, n_rows_out, L);
  constexpr int G = NT / L;
  const int tid = threadIdx.x, env0 = blockIdx.x * G;
  const int g = tid / L;
  Lanes ln;
  ln.lane = tid % L;
  ln.mask = L == 32 ? 0xffffffffu : ((1u << L) - 1u) << ((tid & 31) & ~(L - 1));
  int* tab = reinterpret_cast<int*>(smem + m.o_tab);
  float* rec = smem + m.o_rec + g * m.stride;
  float* sh_out = smem + m.o_out;
  float* sh_act = smem + m.o_act;
  float4* buf = smem4 + g * m.n_max;

  // the world's table, once per block; the G envs' input rows, row by row
  // over neighbouring envs
  for (int i = tid; i < sp.n_tab; i += NT) tab[i] = __ldg(gtab + i);
  for (int i = tid; i < m.R_x * G; i += NT) {
    const int r = i / G, gg = i % G, b = env0 + gg;
    smem[m.o_rec + gg * m.stride + r] = b < B ? __ldg(x + (size_t)r * B + b) : 0.f;
  }
  __syncthreads();

  EnvRows s;
  s.px = rec;
  s.py = rec + E;
  s.vx = rec + 2 * E;
  s.vy = rec + 3 * E;
  s.rot = rec + 4 * E;
  s.w = rec + 5 * E;
  s.fx = rec + 6 * E;
  s.fy = rec + 7 * E;
  s.tq = rec + 8 * E;
  s.jfr = rec + 9 * E;
  // the scratch rows follow the joint rows and, with dynamic gravity (the
  // fused form only), its 2E rows; the controller rows follow the scratch
  // rows in the carry
  s.dg = rec + 9 * E + sp.J;
  float* scratch = rec + 9 * E + sp.J + (ROWS ? 0 : 2 * E * sp.dyn_g);
  float* ctrl = scratch + sp.K_in;
  s.Fx = rec + m.R_x;
  s.Fy = s.Fx + E;
  s.Tq = s.Fx + 2 * E;
  s.C = s.Fx + 3 * E;
  s.S = s.Fx + 4 * E;

  // the fused form runs one step: a constant bound lets the compiler drop
  // the loop there
  const int n_steps = ROWS ? k_steps : 1;
  for (int step = 0; step < n_steps; ++step) {
    if (ROWS) {
      // this step's action rows, then on one lane of each group the action
      // override (holonomic process_action: force = u) and the scenario's
      // process_action, which writes its hook rows after the emit rows
      const float* a = act + (size_t)step * 2 * sp.n_act * B;
      for (int i = tid; i < 2 * sp.n_act * G; i += NT) {
        const int r = i / G, b = env0 + i % G;
        sh_act[i] = b < B ? __ldg(a + (size_t)r * B + b) : 0.f;
      }
      __syncthreads();
      if (ln.lane == 0) {
        for (int i = 0; i < sp.n_act; ++i) {
          const int e = sp.act_slot[i];
          s.fx[e] = sh_act[i * G + g];
          s.fy[e] = sh_act[(sp.n_act + i) * G + g];
        }
        run_act(ap, s.px, s.py, s.vx, s.vy, s.fx, s.fy, ctrl, sh_out + (n_rows_out - act_out_rows(ap)) * G, G, g);
      }
      __syncwarp(ln.mask);
    }

    physics<L>(sp, tab, ln, buf, s);

    // the emit rows, on one lane of each group, into the block's output rows
    if (ln.lane == 0) {
      run_emit<Emit>(ep, s.px, s.py, s.vx, s.vy, s.rot, s.w, s.fx, s.fy, scratch, sh_out, G, g);
      if (ROWS) {
        // the scratch rows carry the emit rows the scenario names
        for (int k = 0; k < sp.K_in; ++k) {
          const int ei = ep.carry_idx[k];
          if (ei >= 0) scratch[k] = sh_out[ei * G + g];
        }
      }
    }
    __syncthreads();
    // the output rows: this step's block of the rows form's extra rows (its
    // emit rows, then its hook rows), or the fused form's rows after the
    // state rows
    float* o = ROWS ? extra + (size_t)step * n_rows_out * B : out + (size_t)9 * E * B;
    for (int i = tid; i < n_rows_out * G; i += NT) {
      const int r = i / G, b = env0 + i % G;
      if (b < B) o[(size_t)r * B + b] = sh_out[i];
    }
  }

  // the state rows; the rows form's carry also holds the joints' fixed
  // rotations (unchanged), the scratch and the controller rows
  const int n_store = ROWS ? m.R_x : 9 * E;
  for (int i = tid; i < n_store * G; i += NT) {
    const int r = i / G, gg = i % G, b = env0 + gg;
    if (b < B) out[(size_t)r * B + b] = smem[m.o_rec + gg * m.stride + r];
  }
}

// The one-thread form (L = 1): one thread per env, blocks of NT, the env's
// state in per-thread arrays, the pair tables read from device memory and
// the per-entity constants from the block's copy in shared memory (the
// launch gives it 16E words).
template <bool ROWS, class Emit>
__global__ void __launch_bounds__(NT)
fused_step_kernel_thread(const FusedSpec sp, const EmitParams ep, const ActParams ap, const int* __restrict__ tab,
                  const float* __restrict__ x,
                  const float* __restrict__ act, float* __restrict__ out,
                  float* __restrict__ extra, int B, int k_steps, int n_tot) {
  // the per-entity constants, once per block, into dynamic shared memory
  extern __shared__ float4 smem4[];
  int* ent = reinterpret_cast<int*>(smem4);
  for (int i = threadIdx.x; i < N_ENT_FIELDS * sp.E; i += NT) ent[i] = __ldg(tab + sp.o_ent + i);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int E = sp.E;
  float px[MAX_E], py[MAX_E], vx[MAX_E], vy[MAX_E], rot[MAX_E], w[MAX_E];
  float fx[MAX_E], fy[MAX_E], tq[MAX_E], scratch[MAX_K], ctrl[MAX_CTRL];
  for (int e = 0; e < E; ++e) {
    px[e] = x[(0 * E + e) * B + b];
    py[e] = x[(1 * E + e) * B + b];
    vx[e] = x[(2 * E + e) * B + b];
    vy[e] = x[(3 * E + e) * B + b];
    rot[e] = x[(4 * E + e) * B + b];
    w[e] = x[(5 * E + e) * B + b];
    fx[e] = x[(6 * E + e) * B + b];
    fy[e] = x[(7 * E + e) * B + b];
    tq[e] = x[(8 * E + e) * B + b];
  }
  // the scratch rows follow the joint rows and, with dynamic gravity (the
  // fused form only), its 2E rows
  const int o_scr = 9 * E + sp.J + (ROWS ? 0 : 2 * E * sp.dyn_g);
  for (int k = 0; k < sp.K_in; ++k) scratch[k] = x[(o_scr + k) * B + b];
  // the controller rows follow the scratch rows in the carry
  const int n_ctrl = ROWS ? act_ctrl_rows(ap) : 0;
  for (int k = 0; k < n_ctrl; ++k) ctrl[k] = x[(9 * E + sp.J + sp.K_in + k) * B + b];

  // the fused form runs one step: a constant bound lets the compiler drop
  // the loop there
  const int n_steps = ROWS ? k_steps : 1;
  for (int step = 0; step < n_steps; ++step) {
    // the rows form's block of output rows for this step: its emit rows,
    // then its hook rows
    float* blk = extra + (size_t)step * n_tot * B;
    if (ROWS) {
      // this step's decoded actions override the agents' force rows
      // (holonomic process_action: force = u)
      const float* a = act + (size_t)step * 2 * sp.n_act * B;
      for (int i = 0; i < sp.n_act; ++i) {
        int e = sp.act_slot[i];
        fx[e] = a[i * B + b];
        fy[e] = a[(sp.n_act + i) * B + b];
      }
      // the scenario's process_action (its kind is the same for every thread)
      run_act(ap, px, py, vx, vy, fx, fy, ctrl, blk + (size_t)(n_tot - act_out_rows(ap)) * B, B, b);
    }

    physics_thread(sp, tab, ent, x + (size_t)9 * E * B, x + (size_t)(9 * E + sp.J) * B, B, b, px, py, vx, vy, rot,
                   w, fx, fy, tq);

    // the emit rows follow the state rows (fused step) or open this step's
    // block (rows step)
    float* emit_rows = ROWS ? blk : out + (size_t)9 * E * B;
    run_emit<Emit>(ep, px, py, vx, vy, rot, w, fx, fy, scratch, emit_rows, B, b);
    if (ROWS) {
      // the scratch rows carry the emit rows the scenario names (this
      // thread wrote them)
      for (int k = 0; k < sp.K_in; ++k) {
        int ei = ep.carry_idx[k];
        if (ei >= 0) scratch[k] = emit_rows[(size_t)ei * B + b];
      }
    }
  }

  for (int e = 0; e < E; ++e) {
    out[(0 * E + e) * B + b] = px[e];
    out[(1 * E + e) * B + b] = py[e];
    out[(2 * E + e) * B + b] = vx[e];
    out[(3 * E + e) * B + b] = vy[e];
    out[(4 * E + e) * B + b] = rot[e];
    out[(5 * E + e) * B + b] = w[e];
    out[(6 * E + e) * B + b] = fx[e];
    out[(7 * E + e) * B + b] = fy[e];
    out[(8 * E + e) * B + b] = tq[e];
  }
  if (ROWS) {
    // joint fixed rotations ride the carry unchanged, then the scratch and
    // the controller rows
    for (int j = 0; j < sp.J; ++j) out[(9 * E + j) * B + b] = x[(9 * E + j) * B + b];
    for (int k = 0; k < sp.K_in; ++k) out[(9 * E + sp.J + k) * B + b] = scratch[k];
    for (int k = 0; k < n_ctrl; ++k) out[(9 * E + sp.J + sp.K_in + k) * B + b] = ctrl[k];
  }
}

template <bool ROWS, class Emit, int L>
static int launch(const FusedSpec& sp, const EmitParams& ep, const ActParams& ap, const int* tab, const float* x,
                  const float* act, float* out, float* extra, int B, int k_steps, int n_rows_out, size_t smem,
                  cudaStream_t s) {
  // above 48 KB a block's dynamic shared memory needs the kernel's opt-in,
  // set once per instantiation to the largest size asked so far
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(fused_step_kernel<ROWS, Emit, L>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  constexpr int G = NT / L;
  fused_step_kernel<ROWS, Emit, L><<<(B + G - 1) / G, NT, smem, s>>>(sp, ep, ap, tab, x, act, out, extra, B,
                                                                    k_steps, n_rows_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROWS, class Emit>
static int launch_lanes(int lanes, const FusedSpec& sp, const EmitParams& ep, const ActParams& ap, const int* tab,
                        const float* x, const float* act, float* out, float* extra, int B, int k_steps,
                        int n_rows_out, size_t smem, cudaStream_t s) {
  if (lanes == 1) {
    fused_step_kernel_thread<ROWS, Emit><<<(B + NT - 1) / NT, NT, smem, s>>>(sp, ep, ap, tab, x, act, out, extra, B,
                                                                            k_steps, n_rows_out);
    return static_cast<int>(cudaGetLastError());
  }
#define LANES(L) launch<ROWS, Emit, L>(sp, ep, ap, tab, x, act, out, extra, B, k_steps, n_rows_out, smem, s)
  if (lanes == 8) return LANES(8);
#ifdef VMAS_FUSED_ALL_LANES
  if (lanes == 4) return LANES(4);
  if (lanes == 16) return LANES(16);
  if (lanes == 32) return LANES(32);
#endif
#undef LANES
  return cudaErrorInvalidValue;
}

// the device's limit, read once per device
static int max_smem_optin() {
  static int limit[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (limit[dev] == 0 &&
      cudaDeviceGetAttribute(&limit[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    limit[dev] = 0;
  return limit[dev];
}

extern "C" {

// The dynamic shared memory, in bytes, of one block of the kernel with
// `lanes` lanes per env (rows_mode, n_ctrl controller rows and n_rows_out
// output rows as vmas_fused_step takes them); 16E words in the one-thread
// form.
long long vmas_fused_smem(const FusedSpec* spec, int lanes, int rows_mode, int n_ctrl, int n_rows_out) {
  // the one-thread form holds the per-entity constants there
  return lanes == 1 ? 4LL * N_ENT_FIELDS * spec->E
                    : 4LL * smem_layout(*spec, rows_mode != 0, n_ctrl, n_rows_out, lanes).words;
}

// The largest dynamic shared memory a block may opt in to on the current
// device, in bytes.
int vmas_max_smem() { return max_smem_optin(); }

// Launch one fused step on `stream`, `lanes` lanes per env: 1, the one-thread
// form; 8 (and 4, 16 or 32 in a build with VMAS_FUSED_ALL_LANES), the group
// form.
// tab: the world's joint and pair tables and lane lists (int32 words,
// FusedSpec's offsets, spec->n_tab of them). rows_mode = 0: x [9E + J (+ 2E
// with spec->dyn_g) + K_in, B] -> out [9E + n_tot, B] (n_tot: the emit's
// rows), k_steps 1, ap->kind ACT_NONE. rows_mode = 1: x = carry [R_in, B],
// act [k_steps * 2A, B] -> out = carry' [R_in, B], extra [k_steps * n_tot, B]
// (per step n_out emit rows, then act_out_rows(*ap) hook rows: 2 per PID
// agent, or the ball's 2); it needs an emit and takes no dynamic gravity. An
// unknown emit kind, act kind or lane count, a k_steps, n_pid, ball slot or
// n_tot out of range, or a block's shared memory beyond the device's limit
// returns cudaErrorInvalidValue; else cudaGetLastError().
int vmas_fused_step(const FusedSpec* spec, const EmitParams* ep, const ActParams* ap, int emit_kind, int lanes,
                    const int* tab, const float* x, const float* act, float* out, float* extra, int B,
                    int rows_mode, int k_steps, int n_tot, void* stream) {
  if (k_steps < 1 || ap->n_pid < 0 || ap->n_pid > MAX_PID || n_tot < 0) return cudaErrorInvalidValue;
  if (ap->kind != ACT_NONE && ap->kind != ACT_PID && ap->kind != ACT_BALL) return cudaErrorInvalidValue;
  if (ap->kind == ACT_BALL && (ap->ball.slot < 0 || ap->ball.slot >= spec->E)) return cudaErrorInvalidValue;
  if (!rows_mode && (k_steps != 1 || ap->kind != ACT_NONE)) return cudaErrorInvalidValue;
  if (rows_mode && (n_tot < act_out_rows(*ap) || spec->dyn_g)) return cudaErrorInvalidValue;
  if (lanes != 1 && lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32) return cudaErrorInvalidValue;
#ifndef VMAS_FUSED_ALL_LANES
  if (lanes != 1 && lanes != 8) return cudaErrorInvalidValue;
#endif
  const size_t smem = (size_t)vmas_fused_smem(spec, lanes, rows_mode, rows_mode ? act_ctrl_rows(*ap) : 0, n_tot);
  if (smem > (size_t)max_smem_optin()) return cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(ROWS, EMIT) \
  launch_lanes<ROWS, EMIT>(lanes, *spec, *ep, *ap, tab, x, act, out, extra, B, k_steps, n_tot, smem, s)
  if (rows_mode) {
    if (emit_kind == EMIT_TRANSPORT) return LAUNCH(true, TransportEmit);
    if (emit_kind == EMIT_BALANCE) return LAUNCH(true, BalanceEmit);
    if (emit_kind == EMIT_JOINT_PASSAGE) return LAUNCH(true, JointPassageEmit);
    if (emit_kind == EMIT_WATERFALL) return LAUNCH(true, WaterfallEmit);
    if (emit_kind == EMIT_GIVE_WAY) return LAUNCH(true, GiveWayEmit);
    if (emit_kind == EMIT_MULTI_GIVE_WAY) return LAUNCH(true, MultiGiveWayEmit);
    if (emit_kind == EMIT_SIMPLE) return LAUNCH(true, SimpleEmit);
    if (emit_kind == EMIT_SIMPLE_SPREAD) return LAUNCH(true, SimpleSpreadEmit);
    if (emit_kind == EMIT_SIMPLE_PUSH) return LAUNCH(true, SimplePushEmit);
    if (emit_kind == EMIT_SIMPLE_ADVERSARY) return LAUNCH(true, SimpleAdversaryEmit);
    if (emit_kind == EMIT_SIMPLE_TAG) return LAUNCH(true, SimpleTagEmit);
    if (emit_kind == EMIT_SIMPLE_REFERENCE) return LAUNCH(true, SimpleReferenceEmit);
    if (emit_kind == EMIT_SPEAKER_LISTENER) return LAUNCH(true, SpeakerListenerEmit);
    if (emit_kind == EMIT_SIMPLE_WORLD_COMM) return LAUNCH(true, SimpleWorldCommEmit);
    if (emit_kind == EMIT_REVERSE_TRANSPORT) return LAUNCH(true, ReverseTransportEmit);
    if (emit_kind == EMIT_WHEEL) return LAUNCH(true, WheelEmit);
    if (emit_kind == EMIT_PASSAGE) return LAUNCH(true, PassageEmit);
    if (emit_kind == EMIT_DISPERSION) return LAUNCH(true, DispersionEmit);
    if (emit_kind == EMIT_DROPOUT) return LAUNCH(true, DropoutEmit);
    if (emit_kind == EMIT_BUZZ_WIRE) return LAUNCH(true, BuzzWireEmit);
    if (emit_kind == EMIT_BALL_TRAJECTORY) return LAUNCH(true, BallTrajectoryEmit);
    if (emit_kind == EMIT_BALL_PASSAGE) return LAUNCH(true, BallPassageEmit);
    if (emit_kind == EMIT_JOINT_PASSAGE_SIZE) return LAUNCH(true, JointPassageSizeEmit);
    if (emit_kind == EMIT_NAVIGATION) return LAUNCH(true, NavigationEmit);
    if (emit_kind == EMIT_FLOCKING) return LAUNCH(true, FlockingEmit);
    if (emit_kind == EMIT_FOOTBALL) return LAUNCH(true, FootballEmit);
  } else {
    if (emit_kind == EMIT_NONE) return LAUNCH(false, NoEmit);
    if (emit_kind == EMIT_TRANSPORT) return LAUNCH(false, TransportEmit);
    if (emit_kind == EMIT_BALANCE) return LAUNCH(false, BalanceEmit);
    if (emit_kind == EMIT_JOINT_PASSAGE) return LAUNCH(false, JointPassageEmit);
    if (emit_kind == EMIT_WATERFALL) return LAUNCH(false, WaterfallEmit);
    if (emit_kind == EMIT_GIVE_WAY) return LAUNCH(false, GiveWayEmit);
    if (emit_kind == EMIT_MULTI_GIVE_WAY) return LAUNCH(false, MultiGiveWayEmit);
    if (emit_kind == EMIT_SIMPLE) return LAUNCH(false, SimpleEmit);
    if (emit_kind == EMIT_SIMPLE_SPREAD) return LAUNCH(false, SimpleSpreadEmit);
    if (emit_kind == EMIT_SIMPLE_PUSH) return LAUNCH(false, SimplePushEmit);
    if (emit_kind == EMIT_SIMPLE_ADVERSARY) return LAUNCH(false, SimpleAdversaryEmit);
    if (emit_kind == EMIT_SIMPLE_TAG) return LAUNCH(false, SimpleTagEmit);
    if (emit_kind == EMIT_SIMPLE_REFERENCE) return LAUNCH(false, SimpleReferenceEmit);
    if (emit_kind == EMIT_SPEAKER_LISTENER) return LAUNCH(false, SpeakerListenerEmit);
    if (emit_kind == EMIT_SIMPLE_WORLD_COMM) return LAUNCH(false, SimpleWorldCommEmit);
    if (emit_kind == EMIT_REVERSE_TRANSPORT) return LAUNCH(false, ReverseTransportEmit);
    if (emit_kind == EMIT_WHEEL) return LAUNCH(false, WheelEmit);
    if (emit_kind == EMIT_PASSAGE) return LAUNCH(false, PassageEmit);
    if (emit_kind == EMIT_DISPERSION) return LAUNCH(false, DispersionEmit);
    if (emit_kind == EMIT_DROPOUT) return LAUNCH(false, DropoutEmit);
    if (emit_kind == EMIT_HET_MASS) return LAUNCH(false, HetMassEmit);
    if (emit_kind == EMIT_BUZZ_WIRE) return LAUNCH(false, BuzzWireEmit);
    if (emit_kind == EMIT_BALL_TRAJECTORY) return LAUNCH(false, BallTrajectoryEmit);
    if (emit_kind == EMIT_BALL_PASSAGE) return LAUNCH(false, BallPassageEmit);
    if (emit_kind == EMIT_JOINT_PASSAGE_SIZE) return LAUNCH(false, JointPassageSizeEmit);
    if (emit_kind == EMIT_NAVIGATION) return LAUNCH(false, NavigationEmit);
    if (emit_kind == EMIT_FLOCKING) return LAUNCH(false, FlockingEmit);
    if (emit_kind == EMIT_DISCOVERY) return LAUNCH(false, DiscoveryEmit);
    if (emit_kind == EMIT_FOOTBALL) return LAUNCH(false, FootballEmit);
  }
#undef LAUNCH
  return cudaErrorInvalidValue;
}

const char* vmas_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
