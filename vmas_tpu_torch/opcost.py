"""The op-cost probe: one thread's serial chain of dependent operations.

Counterpart of the Pallas probe in tests/golden/time_mosaic_opcost.py
(``make_kernel``, at its ``(1, B)`` row shape): ``R`` rows ``[R, B]`` in, a
chain of ``n_ops`` dependent elementwise operations into row 0, operation
``i`` reading row ``(i + 1) % R``, rows 1..R-1 copied out. The ALU chain
runs ``acc * r + 0.5``, ``where(acc > r, acc - r, acc)`` and ``max(acc, r *
0.25)`` by ``i % 3``; the transcendental chain ``sqrt(acc * acc + r * r)``,
``acc / (|r| + 1.5)``, ``exp(-|acc|) + r`` and ``log1p(|acc|) + r * 0.25`` by
``i % 4``. ``tools/time_opcost.py`` times it on the card, to give the cost
per operation of the serial per-thread chains the fused physics kernel
runs.

``opcost_chain`` launches the CUDA kernel (``csrc/opcost.cu``) for a GPU
tensor and runs the plain version for a CPU tensor; ``opcost_launches``
counts the kernel's launches.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch import _kernels as K

MAX_R = 64  # csrc/opcost.cu

opcost_launches = 0


def opcost_chain_plain(x, n_ops: int, trans: bool = False):
    """The probe's plain version: ``x`` [R, B] -> [R, B], the chain's result
    in row 0 and the other rows unchanged."""
    rows = list(x)
    R = len(rows)
    acc = rows[0]
    for i in range(n_ops):
        r = rows[(i + 1) % R]
        if trans:
            if i % 4 == 0:
                acc = torch.sqrt(acc * acc + r * r)
            elif i % 4 == 1:
                acc = acc / (torch.abs(r) + 1.5)
            elif i % 4 == 2:
                acc = torch.exp(-torch.abs(acc)) + r
            else:
                acc = torch.log1p(torch.abs(acc)) + r * 0.25
        elif i % 3 == 0:
            acc = acc * r + 0.5
        elif i % 3 == 1:
            acc = torch.where(acc > r, acc - r, acc)
        else:
            acc = torch.maximum(acc, r * 0.25)
    return torch.stack([acc] + rows[1:])


def opcost_chain(x, n_ops: int, trans: bool = False, block: int = 128, out=None):
    """The probe on ``x`` [R, B] f32: the CUDA kernel (one thread per column,
    blocks of ``block`` threads) for a GPU tensor, writing into ``out`` if
    given, the plain version for a CPU tensor."""
    global opcost_launches
    if x.device.type == "cpu":
        return opcost_chain_plain(x, n_ops, trans)
    R, B = x.shape
    K.check_tensor("x", x, torch.float32, (R, B))
    if not 1 <= R <= MAX_R or n_ops < 0 or block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"opcost takes 1..{MAX_R} rows, n_ops >= 0 and a block of 32..1024 threads in steps of 32; "
                         f"got R={R}, n_ops={n_ops}, block={block}")
    if out is None:
        out = torch.empty_like(x)
    K.check_tensor("out", out, torch.float32, (R, B))
    lib = K.library("opcost")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vmas_opcost(x.data_ptr(), out.data_ptr(), R, B, int(n_ops), int(bool(trans)), int(block), stream)
    if err != 0:
        raise RuntimeError(f"opcost kernel launch failed: {lib.vmas_opcost_error_string(err).decode()}")
    opcost_launches += 1
    return out
