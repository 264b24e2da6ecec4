"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``. Libraries are built at first use
into ``_build/`` beside this file, named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

The ``ctypes`` structures below mirror ``csrc/fused_step.cu``'s structs field for
field; the kernel takes them by value (the world's constants, the emit's and
the in-kernel PID's), and the world's joint and pair tables by pointer
(``core.fused.KernelSpec.pair_table``). ``csrc/road_traffic.cu`` and
``csrc/opcost.cu`` take plain pointers and scalars.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# kernel name -> its source; one nvcc process per source
SOURCES = {"fused_step": "fused_step.cu", "road_traffic": "road_traffic.cu", "opcost": "opcost.cu"}

# capacities of the fused kernel (csrc/fused_step.cu): entities (the
# one-thread form's per-thread arrays), policy agents (action slots and the
# emits' per-agent tables), scratch rows, transport's packages; the joint
# and pair tables, the lane lists and the per-entity constants are a device
# buffer of any length. core.fused.check_fusable holds a world to them when
# its Environment is built.
MAX_E = 64
MAX_A = 32
MAX_K = 16
MAX_P = 4
MAX_PID = 8  # PID-controlled agents (ActParams)
MAX_RC = 4  # distinct agent radii of an MPE emit's collision tests

# the per-entity constants in the table buffer, one block of E words per
# field from FusedSpec.o_ent, in this order (csrc/fused_step.cu P_*); the
# flags an int, the others floats stored by their bits
ENT_FIELDS = ("flags", "inv_mass", "inv_moi", "drag_fac", "max_f", "f_range", "max_t", "t_range", "max_speed",
              "v_range", "lfm", "mass", "afm", "moi", "gsx", "gsy")

# per-entity flag bits (the flags field)
F_MOVABLE = 1
F_ROTATABLE = 2
F_MAX_F = 4
F_F_RANGE = 8
F_MAX_T = 16
F_T_RANGE = 32
F_LIN_FRIC = 64
F_ANG_FRIC = 128
F_GRAVITY = 256
F_DRAG = 512
F_MAX_SPEED = 1024
F_V_RANGE = 2048
F_TRIG = 4096  # a joint or a pair reads the entity's rotation

# FusedOutputs.emit realizations compiled into the kernel
EMIT_NONE = 0
EMIT_TRANSPORT = 1
EMIT_BALANCE = 2
EMIT_JOINT_PASSAGE = 3
EMIT_WATERFALL = 4
EMIT_GIVE_WAY = 5
EMIT_MULTI_GIVE_WAY = 6
EMIT_SIMPLE = 7
EMIT_SIMPLE_SPREAD = 8
EMIT_SIMPLE_PUSH = 9
EMIT_SIMPLE_ADVERSARY = 10
EMIT_SIMPLE_TAG = 11
EMIT_SIMPLE_REFERENCE = 12
EMIT_SPEAKER_LISTENER = 13
EMIT_SIMPLE_WORLD_COMM = 14
EMIT_REVERSE_TRANSPORT = 15
EMIT_WHEEL = 16
EMIT_PASSAGE = 17
EMIT_DISPERSION = 18
EMIT_DROPOUT = 19
EMIT_HET_MASS = 20
EMIT_BUZZ_WIRE = 21
EMIT_BALL_TRAJECTORY = 22
EMIT_BALL_PASSAGE = 23
EMIT_JOINT_PASSAGE_SIZE = 24
EMIT_NAVIGATION = 25
EMIT_FLOCKING = 26
EMIT_DISCOVERY = 27

_i, _f = ctypes.c_int, ctypes.c_float


class FusedSpec(ctypes.Structure):
    _fields_ = [
        ("E", _i), ("J", _i), ("K_in", _i), ("substeps", _i),
        ("n_ss", _i), ("n_ls", _i), ("n_ll", _i), ("n_bs", _i), ("n_bl", _i), ("n_bb", _i),
        ("o_j", _i), ("o_ss", _i), ("o_ls", _i), ("o_ll", _i), ("o_bs", _i), ("o_bl", _i), ("o_bb", _i),
        ("o_lst", _i), ("o_ent", _i), ("n_tab", _i),
        ("n_act", _i), ("has_x", _i), ("has_y", _i), ("dyn_g", _i),
        ("sub_dt", _f), ("cm", _f), ("cf", _f), ("x_semidim", _f), ("y_semidim", _f),
        ("jf", _f), ("tcf", _f),
        ("act_slot", _i * MAX_A),
    ]


class TransportParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("n_pkgs", _i), ("goal", _i),
        ("agent", _i * MAX_A), ("pkg", _i * MAX_P),
        ("hw", _f * MAX_P), ("hl", _f * MAX_P),
        ("og_dmin", _f), ("factor", _f),
    ]


class BalanceParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A),
        ("goal", _i), ("pkg", _i), ("line", _i), ("floor", _i),
        ("pkg_r", _f), ("goal_r", _f), ("pkg_dmin", _f),
        ("line_half", _f), ("floor_hw", _f), ("floor_hl", _f),
        ("factor", _f), ("fall_rew", _f),
    ]


class JointPassageParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A),
        ("jl", _i), ("goal", _i),
        ("n_open", _i), ("open", _i * MAX_E),
        ("pw_half", _f), ("pos_f", _f), ("rot_f", _f), ("middle", _f),
        ("all_rot", _i), ("obs_joint", _i),
    ]


class WaterfallParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A),
        ("n_lm", _i), ("lm", _i * MAX_E),
        ("goal", _i),
    ]


class GiveWayParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A), ("goal", _i * MAX_A),
        ("goal_r", _f * MAX_A), ("factor", _f), ("final", _f), ("rel_obs", _i),
    ]


class MultiGiveWayParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A), ("goal", _i * MAX_A),
        ("goal_r", _f * MAX_A), ("factor", _f), ("factor_zero", _i), ("final", _f),
        ("coll_pen", _f), ("min_coll", _f), ("two_r", _f),
    ]


class SimpleParams(ctypes.Structure):
    """The policy agents are entities ``a0 .. a0 + n_agents - 1`` and the
    landmarks ``l0 .. l0 + n_lm - 1``."""

    _fields_ = [("n_agents", _i), ("a0", _i), ("n_lm", _i), ("l0", _i)]


class SimpleSpreadParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("a0", _i), ("n_lm", _i), ("l0", _i),
        ("obs_others", _i), ("radius", _f * MAX_A),
    ]


class MpeTeamParams(ctypes.Structure):
    """simple_push's and simple_adversary's: the agents' and landmarks'
    runs of entity indices, and which agents are adversaries."""

    _fields_ = [("n_agents", _i), ("a0", _i), ("n_lm", _i), ("l0", _i), ("adversary", _i * MAX_A)]


class SimpleTagParams(ctypes.Structure):
    """Each agent's role, whether it collides and its radius class;
    ``hit_r[i * MAX_RC + j]`` is the collision distance of classes i and j,
    the two radii summed in double precision and rounded once."""

    _fields_ = [
        ("n_agents", _i), ("a0", _i), ("n_lm", _i), ("l0", _i),
        ("adversary", _i * MAX_A), ("collide", _i * MAX_A), ("rcls", _i * MAX_A),
        ("hit_r", _f * (MAX_RC * MAX_RC)),
        ("shape_agent", _i), ("shape_adv", _i), ("same_team", _i), ("obs_pos", _i), ("obs_vel", _i),
    ]


class SpeakerListenerParams(ctypes.Structure):
    _fields_ = [("n_agents", _i), ("listener", _i), ("n_lm", _i), ("l0", _i)]


class SimpleWorldCommParams(ctypes.Structure):
    """As ``SimpleTagParams``, with the leader, the food entities ``f0 ..
    f0 + n_food - 1`` and ``food_r``, each radius class's distance to a
    food item (rounded once)."""

    _fields_ = [
        ("n_agents", _i), ("a0", _i), ("n_lm", _i), ("l0", _i), ("f0", _i), ("n_food", _i),
        ("adversary", _i * MAX_A), ("leader", _i * MAX_A), ("collide", _i * MAX_A), ("rcls", _i * MAX_A),
        ("hit_r", _f * (MAX_RC * MAX_RC)), ("food_r", _f * MAX_RC),
    ]


class ReverseTransportParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A), ("goal", _i), ("pkg", _i),
        ("hw", _f), ("hl", _f), ("og_dmin", _f), ("factor", _f),
    ]


class WheelParams(ctypes.Structure):
    _fields_ = [("n_agents", _i), ("agent", _i * MAX_A), ("line", _i), ("half", _f), ("v_des", _f)]


class PassageParams(ctypes.Structure):
    """Each agent, its goal and whether it collides; the open passages and
    the walls in world order; the thresholds rounded once from the double
    sums the JAX package compares against."""

    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A), ("goal", _i * MAX_A), ("collide", _i * MAX_A),
        ("n_open", _i), ("n_walls", _i), ("open", _i * MAX_E), ("wall", _i * MAX_E),
        ("hw", _f), ("hl", _f), ("two_r", _f), ("wall_dmin", _f), ("half_r", _f), ("factor", _f),
    ]


class DispersionParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("n_food", _i), ("agent", _i * MAX_A), ("food", _i * MAX_K),
        ("eat_r", _f * MAX_A), ("share", _i), ("by_time", _i),
    ]


class DropoutParams(ctypes.Structure):
    _fields_ = [("n_agents", _i), ("goal", _i), ("agent", _i * MAX_A), ("eat_r", _f * MAX_A)]


class HetMassParams(ctypes.Structure):
    _fields_ = [("n_agents", _i), ("agent", _i * MAX_A)]


class BuzzWireParams(ctypes.Structure):
    """The collidables (the agents, then the ball) with their radii and
    the lines (the walls, then the floors) with their half lengths."""

    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A), ("ball", _i), ("goal", _i),
        ("n_coll", _i), ("coll", _i * (MAX_A + 1)), ("coll_r", _f * (MAX_A + 1)),
        ("n_lines", _i), ("line", _i * MAX_E), ("half", _f * MAX_E),
        ("factor", _f), ("coll_pen", _f),
    ]


class BallTrajectoryParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A), ("ball", _i),
        ("R", _f), ("pos_f", _f), ("speed_f", _f), ("dist_f", _f), ("v_des", _f),
    ]


class BallPassageParams(ctypes.Structure):
    """The collidables (the agents, then the ball) with their contact
    distances, the open passages and the walls in world order; the
    thresholds rounded once from the double sums the JAX package compares
    against."""

    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A), ("ball", _i), ("goal", _i),
        ("n_coll", _i), ("coll", _i * (MAX_A + 1)), ("coll_dmin", _f * (MAX_A + 1)),
        ("n_open", _i), ("n_walls", _i), ("open", _i * MAX_E), ("wall", _i * MAX_E),
        ("hw", _f), ("hl", _f), ("factor", _f), ("coll_pen", _f), ("lo", _f), ("hi", _f),
    ]


class JointPassageSizeParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A), ("jl", _i), ("goal", _i),
        ("pw_half", _f), ("pos_f", _f), ("rot_f", _f), ("mid_180", _i), ("obs_joint", _i),
    ]


class NavigationParams(ctypes.Structure):
    """Each agent, its goal, its goal's radius and its own; ``pair_mask[i]``
    has bit j set where agents i > j collide (the pairs of the collision
    penalty)."""

    _fields_ = [
        ("n_agents", _i), ("agent", _i * MAX_A), ("goal", _i * MAX_A),
        ("goal_r", _f * MAX_A), ("done_r", _f * MAX_A), ("pair_mask", ctypes.c_uint32 * MAX_A),
        ("factor", _f), ("final", _f), ("coll_pen", _f), ("min_coll", _f), ("all_goals", _i),
    ]


class FlockingParams(ctypes.Structure):
    """Every agent in world order (the target, then the policy agents) with
    its radius and policy slot (-1: scripted), and each policy agent's
    position in that order."""

    _fields_ = [
        ("n_agents", _i), ("n_all", _i), ("target", _i),
        ("all", _i * (MAX_A + 1)), ("radius", _f * (MAX_A + 1)), ("slot", _i * (MAX_A + 1)),
        ("policy", _i * MAX_A),
        ("coll_rew", _f), ("min_coll", _f), ("desired", _f), ("factor", _f),
    ]


class DiscoveryParams(ctypes.Structure):
    _fields_ = [
        ("n_agents", _i), ("n_targets", _i), ("agent", _i * MAX_A), ("radius", _f * MAX_A),
        ("target", _i * MAX_E),
        ("cover_r", _f), ("per_target", _f), ("coeff", _f), ("coll_pen", _f), ("min_coll", _f), ("with_coll", _i),
    ]


class _EmitUnion(ctypes.Union):
    _fields_ = [
        ("transport", TransportParams),
        ("balance", BalanceParams),
        ("joint_passage", JointPassageParams),
        ("waterfall", WaterfallParams),
        ("give_way", GiveWayParams),
        ("multi_give_way", MultiGiveWayParams),
        ("simple", SimpleParams),
        ("simple_spread", SimpleSpreadParams),
        ("simple_push", MpeTeamParams),
        ("simple_adversary", MpeTeamParams),
        ("simple_tag", SimpleTagParams),
        ("simple_reference", SimpleParams),
        ("speaker_listener", SpeakerListenerParams),
        ("simple_world_comm", SimpleWorldCommParams),
        ("reverse_transport", ReverseTransportParams),
        ("wheel", WheelParams),
        ("passage", PassageParams),
        ("dispersion", DispersionParams),
        ("dropout", DropoutParams),
        ("het_mass", HetMassParams),
        ("buzz_wire", BuzzWireParams),
        ("ball_trajectory", BallTrajectoryParams),
        ("ball_passage", BallPassageParams),
        ("joint_passage_size", JointPassageSizeParams),
        ("navigation", NavigationParams),
        ("flocking", FlockingParams),
        ("discovery", DiscoveryParams),
    ]


class EmitParams(ctypes.Structure):
    """The scratch-carry map, then the parameters of the one emit a launch
    runs: a union of every emit's, each scenario filling its own member."""

    _anonymous_ = ("u",)
    _fields_ = [("carry_idx", _i * MAX_K), ("u", _EmitUnion)]


class ActParams(ctypes.Structure):
    """The rows form's in-kernel process_action (``core.fused.PidActRows``):
    per PID-controlled agent its entity slot, the optional clamp to
    ``u_rng``, ``min_in`` (0: no zeroing) and the controller's constants;
    ``n_pid = 0`` runs no hook."""

    _fields_ = [
        ("n_pid", _i), ("slot", _i * MAX_PID), ("clamp", _i * MAX_PID),
        ("u_rng", _f * MAX_PID), ("min_in", _f * MAX_PID), ("dt", _f * MAX_PID),
        ("gain", _f * MAX_PID), ("mass", _f * MAX_PID), ("use_i", _i * MAX_PID),
        ("inv_ti", _f * MAX_PID), ("has_cutoff", _i * MAX_PID), ("cutoff", _f * MAX_PID),
        ("td", _f * MAX_PID),
    ]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return nvcc


def _lib_path(name: str, defines=()) -> Path:
    src = _CSRC / SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + [f"-D{d}" for d in defines]).encode())
    for f in sorted(_CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    if defines:
        return _BUILD / "variants" / f"lib{src.stem}_{'_'.join(defines).lower()}_{h.hexdigest()[:16]}.so"
    return _BUILD / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_variant(name: str, defines) -> Path:
    """Build kernel ``name``'s source with the preprocessor ``defines`` (e.g.
    ``VMAS_FUSED_ALL_LANES``: the fused kernel at every lane count of
    ``core.fused.LANES``) into ``_build/variants/``, unless built already,
    keeping nvcc's output beside it; returns the library's path, which
    ``library(name, path)`` loads."""
    out = _lib_path(name, tuple(defines))
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp), str(_CSRC / SOURCES[name])]
        p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed building {out.name}:\n{p.stdout.decode(errors='replace')}")
        out.with_suffix(".log").write_bytes(p.stdout)
        os.replace(tmp, out)
    return out


def build_all() -> float:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together; each build's output (ptxas's registers,
    shared memory and spills per kernel) is kept beside its library
    (``build_log``). Returns the wall seconds it took."""
    t0 = time.perf_counter()
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out))
    for p, tmp, out in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed building {out.name}:\n{log.decode(errors='replace')}")
        out.with_suffix(".log").write_bytes(log)
        os.replace(tmp, out)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output of kernel ``name``'s build (built first if
    needed)."""
    path = _lib_path(name)
    if not path.exists():
        build_all()
    return path.with_suffix(".log").read_text()


def check_tensor(name: str, t, dtype, shape) -> None:
    """Raise ``ValueError`` unless ``t`` is what a kernel takes: a
    contiguous CUDA tensor of ``dtype`` and ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_LIBS = {}


def library(name: str, path=None) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed; with
    ``path``, the library at ``path`` instead (a build of a variant of the
    same source, for the timing tools), bound the same way and not kept."""
    if path is not None:
        return _bind(name, ctypes.CDLL(str(path)))
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = _LIBS[name] = _bind(name, ctypes.CDLL(str(path)))
    return lib


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of kernel ``name``'s C entry points."""
    if name == "fused_step":
        lib.vmas_fused_step.argtypes = [
            ctypes.POINTER(FusedSpec), ctypes.POINTER(EmitParams), ctypes.POINTER(ActParams), ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.vmas_fused_step.restype = ctypes.c_int
        lib.vmas_fused_smem.argtypes = [ctypes.POINTER(FusedSpec), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int]
        lib.vmas_fused_smem.restype = ctypes.c_longlong
        lib.vmas_max_smem.argtypes = []
        lib.vmas_max_smem.restype = ctypes.c_int
        lib.vmas_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vmas_cuda_error_string.restype = ctypes.c_char_p
    elif name == "road_traffic":
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vmas_rt_sweep.argtypes = [p, p, p, p, i, i, i, p, p, p, i, f, f, i, i, i, i, p, p]
        lib.vmas_rt_sweep.restype = ctypes.c_int
        lib.vmas_rt_obs.argtypes = [p] * 8 + [i] * 6 + [f] * 4 + [i, p, p]
        lib.vmas_rt_obs.restype = ctypes.c_int
        lib.vmas_rt_max_smem.argtypes = []
        lib.vmas_rt_max_smem.restype = ctypes.c_int
        lib.vmas_rt_error_string.argtypes = [ctypes.c_int]
        lib.vmas_rt_error_string.restype = ctypes.c_char_p
    elif name == "opcost":
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vmas_opcost.argtypes = [p, p, i, i, i, i, i, p]
        lib.vmas_opcost.restype = ctypes.c_int
        lib.vmas_opcost_error_string.argtypes = [ctypes.c_int]
        lib.vmas_opcost_error_string.restype = ctypes.c_char_p
    return lib
