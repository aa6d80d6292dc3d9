"""Run one cell of the benchmark once and print its result:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Set-up (imports, the kernel library, the host build, the
warm-up of the cell's own shapes) counts as ``setup_s``; then the cell's
traffic runs for ``--seconds``; then the frames kept from the window are
compared with the plain reference (``check.py``).  ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read
from host spans and a ``torch.profiler`` trace of the window (``trace.py``);
a per-layer metric whose source is the host clock is read from an
untraced window of ``--seconds`` that runs before the traced one.
The last line of standard output is one JSON object; the last lines of
standard error give each number compared beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, drivers, frozen, meshes, spec, trace  # noqa: E402

# top-level module names that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracinggpu_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
              "TRITON_CACHE_DIR": ".bench_cache/triton"}


class Run:
    """What a finished run holds for the metric readers."""

    def __init__(self, cell, settings):
        t = cell.traffic
        view = check.view_of(cell, settings)
        self.cell = cell
        self.rays_per_frame = frozen.rays_per_frame(
            view["width"], view["height"], t["spp"], t["max_depth"])
        self.setup_s = self.host_build_s = 0.0
        self.t0 = self.t_end = 0.0
        self.arrivals: list = []
        self.ops = None          # device operations (name, start, end)
        self.spans = None        # trace.Spans of the window
        self.mesh_tests_per_frame = None
        self.launches: dict = {}

    @property
    def frames(self) -> int:
        return len(self.arrivals)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    @property
    def intervals(self) -> np.ndarray:
        """Seconds between one frame's arrival on the host and the next,
        the first from the window's start."""
        return np.diff(np.asarray([self.t0] + self.arrivals))

    @property
    def busy_s(self) -> float | None:
        if not self.ops:
            return None
        return frozen.interval_union([(s, e) for _, s, e in self.ops])


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _launches():
    from raytracinggpu_tpu_torch.ops import _kernels

    return dict(_kernels.LAUNCHES)


def execute(cell, seed: int, seconds: float, traced: bool, device="cuda",
            settings=None, t_start: float | None = None):
    """Run the cell once; returns the result line as a dict, the numbers
    compared and their limits last.  ``settings`` overrides the
    configuration's renderer settings (tests run a small frame on the CPU
    with it)."""
    t_start = T_START if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    chk = check.load(cell.name)
    run = Run(cell, settings)
    mesh = meshes.resolve(cell.config)
    phases = {"imports": time.perf_counter() - t_start}
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
    phases["device"] = time.perf_counter() - t_start
    drv = drivers.make(cell, seed, device, mesh, settings, chk["frames"])
    run.host_build_s = drv.build()
    phases["build"] = time.perf_counter() - t_start
    run.t0 = drv.warm()
    run.setup_s = run.t0 - t_start
    phases["warm"] = run.setup_s
    host = None
    if traced and any(m["source"] == "host_clock" for m in cell.per_layer):
        # the host clock's per-layer readings come from a window of their
        # own, untraced: the trace slows the host by a fifth
        host = Run(cell, settings)
        host.t0 = run.t0
        host.t_end = drv.window(seconds, host.t0)
        host.arrivals, drv.arrivals = drv.arrivals, []
    window = trace.DeviceWindow() if traced and on_card else None
    spans = trace.Spans() if traced else None
    if traced:
        if window is not None:
            window.start()
        run.t0 = drv.warm()  # the tracer's own first costs out of the window
    before = _launches()
    if spans is not None:
        with spans:
            run.t_end = drv.window(seconds, run.t0, spans)
    else:
        run.t_end = drv.window(seconds, run.t0)
    if on_card:
        torch.cuda.synchronize()
    run.arrivals = drv.arrivals
    run.launches = {k: v - before.get(k, 0) for k, v in _launches().items()}
    run.spans = spans
    if window is not None:
        run.ops = [(n, max(s, run.t0), min(e, run.t_end))
                   for n, s, e in window.stop()
                   if e > run.t0 and s < run.t_end]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if traced:
        with trace.MeshWork() as work:
            drv.extra()
        run.mesh_tests_per_frame = work.tests
    items = drv.release()
    del drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    obj_path = mesh.path if mesh is not None else None
    numbers = check.compare(cell, items, obj_path, device, chk["rows"],
                            settings)
    check_s = time.perf_counter() - t_check
    correct = check.verdict(numbers, chk["limits"])
    metrics = {}
    for m in cell.metrics(traced):
        src = host if host is not None and m["source"] == "host_clock" \
            else run
        value = spec.reader(m["name"])(src)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if on_card:
        dev["card"] = frozen.card_line()
    attempted = run.frames + (host.frames if host is not None else 0)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": 0, "metrics": metrics, "device": dev}
    if run.ops is not None:
        dev.update(busy_s=run.busy_s or 0.0, window_s=run.window_s)
        result["breakdown"] = trace.breakdown(
            run.ops, spans.spans if spans else [], run.t0, run.t_end)
    if traced and run.frames:
        result["launches_per_frame"] = {
            k: v / run.frames for k, v in run.launches.items() if v}
    result["setup_phases_s"] = phases
    result["check_s"] = check_s
    result["checked"] = {k: {"value": numbers.get(k), "limit": lim}
                         for k, lim in chk["limits"].items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = os.getcwd()
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(root, sub)
    cell = spec.load_cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = execute(cell, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for k, v in result["checked"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
