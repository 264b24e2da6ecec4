"""A Lidar fault planted under the timed path, to show that the check
catches it: ``Lidar.measure`` casts its rays at their fixed angles, not
turned by the agent's heading. The benchmark's own tests plant it at a
small size on the CPU; on the card

    python3 -m portbench.lidar_fault --workload navigation.rollout --seeds 31 32 33

prints the compared numbers of a sound-window run per seed with the fault
planted, one JSON line each, as ``portbench.calibrate`` prints its faults'.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

from portbench import harness as H


@contextmanager
def planted():
    """Every Lidar of the program measures with its rays unturned."""
    import torch

    from vmas_tpu_torch.sensors import Lidar

    real = Lidar.measure

    def unturned(self, state, vectorized=True):
        angles = torch.as_tensor(self._angles, device=state.device)[None, :].expand(state.batch_dim, -1)
        return self._world.cast_rays(state, self.agent, angles, self.max_range, self.entity_filter)

    Lidar.measure = unturned
    try:
        yield
    finally:
        Lidar.measure = real


def main(argv):
    ap = argparse.ArgumentParser(prog="python -m portbench.lidar_fault", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = H.load_cell(args.workload, Path.cwd())

    import torch

    if not torch.cuda.is_available():
        print("the fault's readings are taken on the card: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {H.card_line()}", file=sys.stderr, flush=True)
    for seed in args.seeds:
        with planted():
            res = cell.runner.run(cell, seed, args.seconds, False, "cuda:0", time.perf_counter())
        torch.cuda.empty_cache()
        readings = {k: c["value"] for k, c in res["checks"].items()}
        print(json.dumps({"cell": cell.name, "what": "fault:lidar_unturned", "seed": seed, "readings": readings,
                          "correct": res["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
