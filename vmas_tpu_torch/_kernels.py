"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``. Libraries are built at first use
into ``_build/`` beside this file, named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

The ``ctypes`` structures below mirror ``csrc/fused_step.cu``'s structs field for
field; the kernel takes them by value.
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
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
# kernel name -> its source; one nvcc process per source
SOURCES = {"fused_step": "fused_step.cu"}

# capacities of the kernel's by-value spec (csrc/fused_step.cu)
MAX_E = 32
MAX_SS = 64
MAX_BS = 16
MAX_A = 16
MAX_K = 8
MAX_P = 4

# per-entity flag bits (FusedSpec.flags)
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

# FusedOutputs.emit realizations compiled into the kernel
EMIT_NONE = 0
EMIT_TRANSPORT = 1

_i, _f = ctypes.c_int, ctypes.c_float


class FusedSpec(ctypes.Structure):
    _fields_ = [
        ("E", _i), ("J", _i), ("K_in", _i), ("substeps", _i),
        ("n_ss", _i), ("n_bs", _i), ("n_act", _i), ("has_x", _i), ("has_y", _i),
        ("sub_dt", _f), ("cm", _f), ("cf", _f), ("x_semidim", _f), ("y_semidim", _f),
        ("flags", _i * MAX_E),
        ("inv_mass", _f * MAX_E), ("inv_moi", _f * MAX_E), ("drag_fac", _f * MAX_E),
        ("max_f", _f * MAX_E), ("f_range", _f * MAX_E),
        ("max_t", _f * MAX_E), ("t_range", _f * MAX_E),
        ("max_speed", _f * MAX_E), ("v_range", _f * MAX_E),
        ("lfm", _f * MAX_E), ("mass", _f * MAX_E), ("afm", _f * MAX_E), ("moi", _f * MAX_E),
        ("gsx", _f * MAX_E), ("gsy", _f * MAX_E),
        ("ss_a", _i * MAX_SS), ("ss_b", _i * MAX_SS), ("ss_dmin", _f * MAX_SS),
        ("bs_box", _i * MAX_BS), ("bs_sph", _i * MAX_BS), ("bs_nh", _i * MAX_BS),
        ("bs_hw", _f * MAX_BS), ("bs_hl", _f * MAX_BS), ("bs_dmin0", _f * MAX_BS),
        ("act_slot", _i * MAX_A),
    ]


class EmitParams(ctypes.Structure):
    _fields_ = [
        ("carry_idx", _i * MAX_K),
        ("n_agents", _i), ("n_pkgs", _i), ("goal", _i),
        ("agent", _i * MAX_A), ("pkg", _i * MAX_P),
        ("hw", _f * MAX_P), ("hl", _f * MAX_P),
        ("og_dmin", _f), ("factor", _f),
    ]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return nvcc


def _lib_path(name: str) -> Path:
    src = _CSRC / SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return _BUILD / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns the wall seconds it took."""
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
        os.replace(tmp, out)
    return time.perf_counter() - t0


_LIBS = {}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        if name == "fused_step":
            lib.vmas_fused_step.argtypes = [
                ctypes.POINTER(FusedSpec), ctypes.POINTER(EmitParams), ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.vmas_fused_step.restype = ctypes.c_int
            lib.vmas_cuda_error_string.argtypes = [ctypes.c_int]
            lib.vmas_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib
