"""The readings a cell's limits are set from, on the chip:

    python3 -m benchmark.calibrate --workload <cell> --seeds S1 S2 ...
        [--control N] [--seconds S] [--frames N] [--fault NAME]

For each seed the cell's renderer is built as a run builds it, its
traffic runs for ``--seconds`` through the timed path, and its kept frames
are compared with the reference as a run compares them; for the first N
seeds the control (the reference in bfloat16 put in the program's place)
is compared too.  ``--frames`` keeps more frames than a run does;
``--fault`` plants one of ``faults.FAULTS`` in the program for every
seed.  One JSON line a seed: the numbers, each kept frame's own, and the
seconds the reference took.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import check, drivers, faults, meshes, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    p.add_argument("--frames", type=int, default=0,
                   help="frames kept a seed (default: the check's)")
    a = p.parse_args(argv)
    cell = spec.load_cell(a.workload)
    chk = check.load(cell.name)
    mesh = meshes.resolve(cell.config)
    obj_path = mesh.path if mesh is not None else None
    for i, seed in enumerate(a.seeds):
        undo = faults.plant(a.fault) if a.fault else []
        try:
            drv = drivers.make(cell, seed, "cuda", mesh, None,
                               a.frames or chk["frames"])
            drv.build()
            drv.window(a.seconds, drv.warm())
            torch.cuda.synchronize()
        finally:
            for u in undo:
                u()
        items = drv.release()
        del drv
        torch.cuda.empty_cache()
        t = time.perf_counter()
        each: list = []
        line = {"seed": seed, "fault": a.fault,
                "program": check.compare(cell, items, obj_path, "cuda",
                                         chk["rows"], each=each),
                "frames": each}
        line["reference_s"] = time.perf_counter() - t
        if i < a.control and not a.fault:
            line["control"] = check.control(cell, items, obj_path,
                                            "cuda", chk["rows"])
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
