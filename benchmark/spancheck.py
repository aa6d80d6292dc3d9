"""Check the program's own tracer against the benchmark's instruments on
one cell, on the card:

    python3 -m benchmark.spancheck --workload <cell> --seed <n>
        [--seconds S]

After the cell's set-up and warm-up, from one process:

1. the cost of the tracer when on: windows of S seconds in turns, untraced
   and with the program's tracer alone (``utils/profiling.tracing``),
   twice each: frames and ms a frame;
2. the cost when off: the tracer's sites a frame (spans, counter
   updates and timed launch wrappers, from the traced windows) and the
   host ns of one disabled site of each kind;
3. a traced window as ``benchmark.run`` makes it (``trace.DeviceWindow``,
   whose profiler session turns the program's tracer on, and
   ``trace.Spans``), then:
   - the clock: the offset of the device's clock from the host's by the
     tracer's clock pairs against ``DeviceWindow``'s marker, and against a
     second marker launched on the idle card after the window;
   - the order: the i-th mesh-query kernel (``pairs_kernel<...>``) on the
     card starts at or after the i-th ``cast.kernel`` span on the host,
     by the tracer's clock pairs; the share that do and the median lag;
   - the launches: each kernel's start less its launch call's (a host
     event, on the clock pairs' clock), least each second, and
     ``cast_idle_ms_per_frame`` and the idle share with the device's
     operations moved each second by it (``launch_clock``);
   - the coverage: the share of the device's idle time in the window that
     lies inside some span of the program, and the host's self time and
     the device's idle time a frame inside each span by name;
   - the ladder: the compacted share of the program's ``ladder`` spans in
     the window against ``ladder_compacted_share`` of the same window;
   - every per-layer metric of the cell that the window gives (the
     checks of ``benchmark.run`` and the mesh-work count are left out).

Prints one JSON object last.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import timeit

import torch

from benchmark import drivers, frozen, meshes, program, spec, trace
from benchmark.run import Run

MESH_QUERY = "pairs_kernel<"


def _window(drv, seconds: float, t0: float) -> tuple:
    """(frames, ms a frame) of a window of ``seconds`` from ``t0``, the
    end of the driver's warm-up."""
    n = len(drv.arrivals)
    t_end = drv.window(seconds, t0)
    torch.cuda.synchronize()
    frames = len(drv.arrivals) - n
    return frames, (t_end - t0) / frames * 1e3


def sites_per_frame(rec, frames: int) -> dict:
    """The tracer's sites a frame in a record of ``frames`` frames: spans,
    counter updates (``count``: two a ladder cast, three more a compacted
    one) and timed launch-wrapper calls."""
    c = rec.counters
    calls = sum(v for k, v in c.items() if k.endswith(".calls"))
    counts = 2 * c.get("ladder.casts", 0) + 3 * c.get("ladder.compacted", 0)
    return {"spans": len(rec.spans) / frames, "counts": counts / frames,
            "timed_calls": calls / frames}


def cost_on(drv, seconds: float) -> tuple:
    """Windows untraced and with the tracer alone, in turns: ({"off":
    [(frames, ms a frame)], "on": [...]}, the sites a frame of each
    traced window)."""
    from raytracinggpu_tpu_torch.utils import profiling

    out, sites = {"off": [], "on": []}, []
    for way in ("off", "on", "off", "on"):
        t0 = drv.warm()
        if way == "on":
            with profiling.tracing():
                frames, ms = _window(drv, seconds, t0)
            sites.append(sites_per_frame(profiling.collect(), frames))
        else:
            frames, ms = _window(drv, seconds, t0)
        out[way].append((frames, ms))
    return out, sites


def off_ns() -> dict:
    """Host ns of one site of each kind with tracing off, less the same
    code without it (best of 5 repeats)."""
    from raytracinggpu_tpu_torch.utils import profiling

    def plain(x):
        return x

    g = {"span": profiling.span, "count": profiling.count,
         "t": profiling.timed("launch.x")(plain), "p": plain}
    n = 200_000

    def best(stmt):
        return min(timeit.repeat(stmt, globals=g, number=n, repeat=5)) / n

    empty = best("pass")
    return {"span": (best("with span('x'):\n    pass") - empty) * 1e9,
            "count": (best("count('x')") - empty) * 1e9,
            "timed": (best("t(1)") - best("p(1)")) * 1e9}


def _joined(events) -> list:
    """(launch start, launch end, kernel start, kernel end, name) in
    profiler-clock ns of each device kernel whose launch call
    (``cudaLaunchKernel*``, a host event) the profiler joined to it by
    correlation id, in the order of the kernels' starts."""
    launches, kernels = {}, []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append(e)
        elif e.name().startswith("cudaLaunchKernel"):
            launches[e.correlation_id()] = e
    out = []
    for k in kernels:
        la = launches.get(k.correlation_id()) \
            or launches.get(k.linked_correlation_id())
        if la is not None:
            out.append((la.start_ns(), la.start_ns() + la.duration_ns(),
                        k.start_ns(), k.start_ns() + k.duration_ns(),
                        k.name()))
    return sorted(out, key=lambda r: r[2])


def launch_clock(window, rec, run, raw) -> dict:
    """The device's timestamps against the host's: each kernel's start
    less its launch call's start (host events, on the clock pairs'
    clock), its least value each second of the window (the device clock's
    offset plus the least launch latency), and the mesh-query kernels'
    launch calls inside their ``cast.kernel`` spans; then the device's
    operations ``raw`` (the two markers first and last) moved each second
    by that least value, so that the kernel that started soonest after its
    launch call starts with it, and ``cast_idle_ms_per_frame`` and the
    idle share read on them."""
    joined = _joined(window.prof.profiler.kineto_results.events())
    out = {"kernels_joined_to_launches": len(joined)}
    if not joined:
        return out
    lo = rec.to_profiler_ns(round(run.t0 * 1e9))
    per_s = {}
    for ls, _, ks, _, _ in joined:
        sec = int((ls - lo) // 1_000_000_000)
        per_s[sec] = min(per_s.get(sec, ks - ls), ks - ls)
    out["kernel_less_launch_us_min_each_s"] = [
        per_s[k] / 1e3 for k in sorted(per_s)]
    casts = [s for s in rec.spans if s.name == "cast.kernel"]
    mesh = [r for r in joined if MESH_QUERY in r[4]]
    if len(mesh) == len(casts):
        inside = [c.start_ns <= rec.from_profiler_ns(ls) <= c.end_ns
                  for (ls, _, _, _, _), c in zip(mesh, casts)]
        out["mesh_launch_inside_cast_kernel_share"] = sum(inside) / len(
            inside)

    def on_host(t):
        sec = int((t - lo) // 1_000_000_000)
        near = min(per_s, key=lambda k: abs(k - sec))
        return rec.from_profiler_ns(t - per_s[near]) * 1e-9

    ops = [(on_host(b), on_host(e)) for b, e, _ in raw[1:-1]]
    gaps = frozen.idle_gaps(ops, run.t0, run.t_end)
    casts = program.spans_in(rec, run.t0, run.t_end, program.CASTS)
    out["cast_idle_ms_per_frame_launch_aligned"] = program.overlap(
        gaps, casts) * 1e3 / run.frames
    out["device_idle_share_launch_aligned"] = sum(
        e - b for b, e in gaps) / run.window_s * 100
    return out


def traced_window(cell, drv, seconds: float, build_s: float) -> dict:
    """A traced window as ``benchmark.run`` makes it, and the checks of the
    module's docstring; ``build_s`` the driver's build."""
    from raytracinggpu_tpu_torch.utils import profiling

    run = Run(cell, None)
    run.host_build_s = build_s
    window = trace.DeviceWindow()
    spans = trace.Spans()
    window.start()
    run.t0 = drv.warm()
    n = len(drv.arrivals)
    with spans:
        run.t_end = drv.window(seconds, run.t0, spans)
    torch.cuda.synchronize()
    time.sleep(0.05)
    end_marker = torch.empty(1, device="cuda")
    h1 = time.perf_counter()
    end_marker.fill_(0.0)
    torch.cuda.synchronize()
    run.arrivals = drv.arrivals[n:]
    run.spans = spans
    ops = window.stop()
    run.ops = [(nm, max(s, run.t0), min(e, run.t_end)) for nm, s, e in ops
               if e > run.t0 and s < run.t_end]
    rec = run.program_trace = profiling.collect()
    if rec is None or not rec.spans \
            or rec.spans[0].start_ns < window.h0 * 1e9:
        raise RuntimeError("the program's tracer did not follow the "
                           "profiler's session")
    raw = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in window.prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA)
    out = {"frames": run.frames, "window_s": run.window_s}
    # the clock: device-clock ns less perf_counter ns at the marker's launch
    marker = raw[0][0] - round(window.h0 * 1e9)
    paired = rec.to_profiler_ns(round(window.h0 * 1e9)) \
        - round(window.h0 * 1e9)
    out["clock_offset_marker_less_pairs_us"] = (marker - paired) / 1e3
    last = raw[-1][0] - round(h1 * 1e9)
    out["clock_offset_end_marker_less_pairs_us"] = (
        last - (rec.to_profiler_ns(round(h1 * 1e9)) - round(h1 * 1e9))) / 1e3
    out["clock_pairs"] = len(rec.clocks)
    # the order of the mesh-query kernels against their host spans
    kernels = [rec.from_profiler_ns(s) for s, _, nm in raw[1:]
               if MESH_QUERY in nm]
    casts = [s.start_ns for s in rec.spans if s.name == "cast.kernel"]
    out["mesh_kernels"], out["cast_kernel_spans"] = len(kernels), len(casts)
    if kernels and len(kernels) == len(casts):
        lags = [k - c for k, c in zip(kernels, casts)]
        out["kernel_after_span_share"] = sum(x >= 0 for x in lags) / len(lags)
        out["kernel_lag_ms_median"] = statistics.median(lags) / 1e6
        out["kernel_lag_ms_min"] = min(lags) / 1e6
    # coverage of the idle time by the program's spans, on either clock
    tops = program.spans_in(rec, run.t0, run.t_end)
    gaps = frozen.idle_gaps([(s, e) for _, s, e in run.ops], run.t0,
                            run.t_end)
    idle = sum(e - s for s, e in gaps)
    out["idle_s"] = idle
    out["idle_in_program_spans_share"] = program.overlap(gaps, tops) / idle
    paired_ops = [(rec.from_profiler_ns(s) * 1e-9,
                   rec.from_profiler_ns(e) * 1e-9) for s, e, _ in raw[1:]]
    pgaps = frozen.idle_gaps(paired_ops, run.t0, run.t_end)
    out["idle_in_program_spans_share_paired_clock"] = program.overlap(
        pgaps, tops) / sum(e - s for s, e in pgaps)
    out.update(launch_clock(window, rec, run, raw))
    # the host's self time a frame by span, and the device's idle time
    # inside each span's own part (the gaps' share of its self time)
    self_ns = rec.self_ns()
    by_name = {}
    for sp, own in zip(rec.spans, self_ns):
        if own is not None and sp.start_ns * 1e-9 >= run.t0 \
                and sp.end_ns * 1e-9 <= run.t_end:
            by_name[sp.name] = by_name.get(sp.name, 0) + own
    out["self_ms_per_frame"] = {k: v / 1e6 / run.frames for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])}
    idle_in = {}
    for name in by_name:
        inner = program.spans_in(rec, run.t0, run.t_end, (name,))
        idle_in[name] = program.overlap(gaps, inner) * 1e3 / run.frames
    out["idle_ms_per_frame_inside"] = dict(sorted(
        idle_in.items(), key=lambda kv: -kv[1]))
    # the ladder: the program's compacted share against the wrapper's
    ladders = [s.attr for s in rec.spans if s.name == "ladder"
               and s.start_ns * 1e-9 >= run.t0
               and s.end_ns * 1e-9 <= run.t_end]
    out["program_compacted_share"] = (sum(1 for C in ladders if C)
                                      / len(ladders) * 100 if ladders
                                      else None)
    out["metrics"] = {m["name"]: spec.reader(m["name"])(run)
                      for m in cell.per_layer
                      if m["source"] != "host_clock"}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("spancheck: needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(a.workload)
    drv = drivers.make(cell, a.seed, "cuda", meshes.resolve(cell.config))
    build_s = drv.build()
    res = {"cell": cell.name, "card": frozen.card_line()}
    res["cost_on"], res["sites_per_frame"] = cost_on(drv, a.seconds)
    ns = res["off_ns_per_site"] = off_ns()
    res["off_us_per_frame"] = [(x["spans"] * ns["span"]
                                + x["counts"] * ns["count"]
                                + x["timed_calls"] * ns["timed"]) / 1e3
                               for x in res["sites_per_frame"]]
    res.update(traced_window(cell, drv, a.seconds, build_s))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
