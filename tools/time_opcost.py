#!/usr/bin/env python3
"""Time the op-cost probe (vmas_tpu_torch/csrc/opcost.cu) on one CUDA GPU.

    python3 tools/time_opcost.py [--out opcost.json]

The probe reads 54 rows [54, B] (one column per thread), runs a chain of N
dependent elementwise operations into row 0 and copies the other rows out:
the serial per-thread chain that the fused physics kernel's threads run,
built with the same flags. It reports, after the card's name and power
limit:

1. the kernel against its plain version at B = 4096 (the ALU chain
   bitwise, the transcendental chain within rtol 1e-5 atol 1e-6);
2. the op sweep: the ALU chain at B = 4096, blocks of 128, N in {0, 100,
   300, 600, 1200}; the slope (ns per operation of one thread's chain, a
   least-squares fit over the points) and the intercept (us at N = 0);
3. the width and block sweep at N = 600: B in {4096, 32768, 262144},
   blocks of 32, 64, 128 and 256 threads (4096 envs in blocks of 128 fill
   32 of the card's 132 SMs);
4. the transcendental chain (sqrt, division, exp, log1p) at B = 4096, N in
   {100, 300, 600}, with its slope.

Each point gives the kernel's device time per launch (torch.profiler, 200
launches) and the wall time per back-to-back call (CUDA events, 500 calls,
the host's launch path included), beside its bound: the larger of the
bytes (2 x 54 x B x 4) over 3.35 TB/s and the operations (N x B) over 67
TFLOP/s. One JSON line per point, then a summary line; with ``--out`` the
whole report is also written to that file. ``op_sweep`` is the probe's
path for chip_smoke.py too.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
R = 54
B = 4096
OPS = (0, 100, 300, 600, 1200)
WIDTHS = (4096, 32768, 262144)
BLOCKS = (32, 64, 128, 256)
SWEEP_OPS = 600
TRANS_OPS = (100, 300, 600)
LAUNCHES = 200
CALLS = 500
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
TRANS_TOL = dict(atol=1e-6, rtol=1e-5)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def probe_inputs(width, seed=0):
    """[54, width] f32 inputs uniform in [0.5, 2) on the GPU."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.rand((R, width), generator=g, device="cuda") * 1.5 + 0.5).contiguous()


def bound_us(width, n_ops):
    """(bound in us, "bytes" or "operations") of one launch."""
    t_bytes = 2 * R * width * 4 / PEAK_BYTES * 1e6
    t_ops = n_ops * width / PEAK_F32 * 1e6
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_point(x, n_ops, trans=False, block=128):
    """Device us per launch (profiler) and wall us per back-to-back call
    (CUDA events) of the probe on ``x``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vmas_tpu_torch.opcost import opcost_chain

    out = torch.empty_like(x)
    run = lambda: opcost_chain(x, n_ops, trans, block, out)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LAUNCHES):
            run()
        torch.cuda.synchronize()
    dev_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA and "opcost_kernel" in ev.name) / LAUNCHES
    if dev_us <= 0:
        raise AssertionError("the profiler saw no opcost_kernel")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        run()
    end.record()
    end.synchronize()
    bound, by = bound_us(x.shape[1], n_ops)
    return {"B": x.shape[1], "n_ops": n_ops, "trans": bool(trans), "block": block, "us": dev_us,
            "wall_us": start.elapsed_time(end) * 1e3 / CALLS, "bound_us": bound, "bound_by": by}


def fit(points, key):
    """Least-squares (slope in ns per operation, intercept in us) of
    ``key`` over the points' n_ops."""
    n = [p["n_ops"] for p in points]
    t = [p[key] for p in points]
    mn, mt = sum(n) / len(n), sum(t) / len(t)
    slope = sum((a - mn) * (b - mt) for a, b in zip(n, t)) / sum((a - mn) ** 2 for a in n)
    return slope * 1e3, mt - slope * mn


def check(width=B, ops=(0, 100, 1200)):
    """The kernel against its plain version at these op counts, both
    chains: the largest difference per chain; raises where the ALU chain is
    not bitwise, the transcendental chain out of TRANS_TOL, or a copied row
    changed."""
    import torch

    from vmas_tpu_torch.opcost import opcost_chain, opcost_chain_plain

    x = probe_inputs(width, seed=1)
    err = {"alu": 0.0, "trans": 0.0}
    for trans in (False, True):
        for n in ops:
            y, p = opcost_chain(x, n, trans), opcost_chain_plain(x, n, trans)
            torch.cuda.synchronize()
            if not torch.equal(y[1:], x[1:]):
                raise AssertionError(f"opcost changed a copied row (n_ops {n}, trans {trans})")
            key = "trans" if trans else "alu"
            err[key] = max(err[key], float((y[0] - p[0]).abs().max()))
            if trans:
                torch.testing.assert_close(y[0], p[0], **TRANS_TOL)
            elif not torch.equal(y[0], p[0]):
                raise AssertionError(f"opcost's ALU chain differs from its plain version at n_ops {n}")
    return err


def op_sweep(width=B, ops=OPS, trans=False, block=128):
    """The probe at each op count: the points, the device slope and
    intercept (ns per operation, us) and the same fitted to the wall
    times."""
    x = probe_inputs(width)
    points = [time_point(x, n, trans, block) for n in ops]
    slope, icpt = fit(points, "us")
    wslope, wicpt = fit(points, "wall_us")
    return {"points": points, "slope_ns": slope, "intercept_us": icpt, "wall_slope_ns": wslope,
            "wall_intercept_us": wicpt}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report as JSON to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_opcost: no CUDA device; this script runs on a GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    from vmas_tpu_torch import _kernels

    card = card_line()
    print(card, flush=True)
    print(f"build: {_kernels.build_all():.1f} s", flush=True)
    report = {"card": card, "max_abs_err": check()}
    print(f"kernel vs plain at B={B}: max abs err {report['max_abs_err']}", flush=True)

    def show(tag, pt):
        print(json.dumps({"sweep": tag, **pt}), flush=True)

    report["alu"] = op_sweep()
    for pt in report["alu"]["points"]:
        show("alu", pt)
    report["widths"] = []
    for width in WIDTHS:
        x = probe_inputs(width)
        for block in BLOCKS:
            pt = time_point(x, SWEEP_OPS, False, block)
            report["widths"].append(pt)
            show("widths", pt)
        del x
    report["trans"] = op_sweep(ops=TRANS_OPS, trans=True)
    for pt in report["trans"]["points"]:
        show("trans", pt)
    summary = {k: report["alu"][k] for k in ("slope_ns", "intercept_us", "wall_slope_ns", "wall_intercept_us")}
    summary.update(trans_slope_ns=report["trans"]["slope_ns"], trans_wall_slope_ns=report["trans"]["wall_slope_ns"])
    print(json.dumps({"summary": summary, "card": card}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
