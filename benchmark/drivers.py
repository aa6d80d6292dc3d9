"""The one traffic generator: a traffic file's ``driver`` names how the
requests are made, and its other keys size them.

- ``frames``: a closed loop of one batch user.  Frame after frame through
  ``api.Renderer.render_hdr(seed=...)``, each with the next seed drawn
  from the run's seed, each read back to the host as the call returns it.
- ``realtime``: the interactive viewer.  ``render/realtime.init_state``,
  then ``step`` frame after frame, pipelined one frame ahead as
  ``run_loop`` does: frame n+1 is enqueued before frame n's uint8 display
  is fetched to the host (pinned memory, one event).

Both keep, by reservoir sampling drawn from the seed, ``check.frames`` of
the frames the window finished, for the check after the window.
"""
from __future__ import annotations

import time

import numpy as np
import torch

FRAME_SEED_MAX = 2**62


class Reservoir:
    """A uniform sample of ``k`` items from a stream of unknown length,
    drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


class Driver:
    """Set-up, the window and what the check needs, for one cell."""

    def __init__(self, cell, seed: int, device, mesh, settings=None,
                 checked_frames: int = 1):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.mesh = mesh  # meshes.Mesh of the configuration, or None
        self.traffic = cell.traffic
        self.settings = dict(cell.config["program"]["settings"],
                             spp=self.traffic["spp"],
                             max_depth=self.traffic["max_depth"])
        self.settings.update(settings or {})
        self.rng = np.random.default_rng([self.seed, 0])
        self.kept = Reservoir(checked_frames,
                              np.random.default_rng([self.seed, 1]))
        self.arrivals: list = []
        self.renderer = None

    def build(self):
        """The program's renderer for the configuration: the preset's host
        build from the configuration's OBJ (the preset's own cat, or the
        resolved file through ``obj_path``) and the tables' upload;
        returns its seconds."""
        from raytracinggpu_tpu_torch import Renderer

        mesh = self.mesh.program_args() if self.mesh is not None else {}
        t0 = time.perf_counter()
        self.renderer = Renderer(self.cell.config["program"]["preset"],
                                 device=self.device, **mesh, **self.settings)
        return time.perf_counter() - t0

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def release(self):
        """Drop the program's state; returns the kept frames as host
        arrays (see ``checked``)."""
        items = self.checked()
        self.renderer = None
        self.state = None
        return items


class Frames(Driver):
    """``frames``: a closed loop of ``render_hdr`` calls."""

    def _next_seed(self) -> int:
        return int(self.rng.integers(FRAME_SEED_MAX))

    def _frame(self, spans):
        s = self._next_seed()
        if spans is None:
            img, _ = self.renderer.render_hdr(seed=s)
        else:
            with spans.span("frame"):
                img, _ = self.renderer.render_hdr(seed=s)
        return s, img

    def warm(self):
        for _ in range(self.traffic["warmup_frames"]):
            self._frame(None)
        self._sync()
        return time.perf_counter()

    def window(self, seconds: float, t0: float, spans=None):
        """Frames until ``seconds`` have passed since ``t0``; each frame's
        arrival (its radiance on the host) is recorded."""
        while True:
            s, img = self._frame(spans)
            t = time.perf_counter()
            self.arrivals.append(t)
            self.kept.offer((s, img))
            if t - t0 >= seconds:
                return t

    def extra(self):
        self._frame(None)

    def checked(self):
        return [{"seed": s, "radiance": img} for s, img in self.kept.items]


class Realtime(Driver):
    """``realtime``: the pipelined progressive loop of ``step``."""

    def build(self):
        from raytracinggpu_tpu_torch.render import realtime as rt

        s = super().build()
        r = self.renderer
        self.state = rt.init_state(r.cfg, r.scene, self.seed)
        self.k = 0
        return s

    def _launch(self, spans):
        """Enqueue the next frame and the copy of its display; returns the
        pending frame (index, accumulations before and after, host
        buffer, event)."""
        from raytracinggpu_tpu_torch.render import realtime as rt

        prev = self.state
        r = self.renderer
        if spans is None:
            self.state, disp = rt.step(r.scene, r.cfg, prev,
                                       self.traffic["light_speed"],
                                       self.traffic["dt"])
        else:
            with spans.span("frame"):
                self.state, disp = rt.step(r.scene, r.cfg, prev,
                                           self.traffic["light_speed"],
                                           self.traffic["dt"])
        if disp.is_cuda:
            host = torch.empty(disp.shape, dtype=disp.dtype, pin_memory=True)
            host.copy_(disp, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = disp, None
        self.k += 1
        return (self.k - 1, prev.accum, self.state.accum, host, done)

    @staticmethod
    def _wait(pending, spans):
        done = pending[4]
        if done is not None:
            if spans is None:
                done.synchronize()
            else:
                with spans.span("readback"):
                    done.synchronize()
        return time.perf_counter()

    def warm(self):
        self.pending = self._launch(None)
        t = None
        for _ in range(self.traffic["warmup_frames"] - 1):
            nxt = self._launch(None)
            t = self._wait(self.pending, None)
            self.pending = nxt
        return t if t is not None else time.perf_counter()

    def window(self, seconds: float, t0: float, spans=None):
        """Frames until ``seconds`` have passed since ``t0``, the arrival
        of the last warm-up display; then the frame still in flight."""
        t = t0
        while True:
            last = t - t0 >= seconds
            nxt = None if last else self._launch(spans)
            t = self._wait(self.pending, spans)
            self.arrivals.append(t)
            k, before, after, host, _ = self.pending
            self.kept.offer((k, before, after, host))
            self.pending = nxt
            if last:
                return t

    def extra(self):
        self.pending = self._launch(None)
        self._wait(self.pending, None)

    def checked(self):
        out = []
        for k, before, after, host, in self.kept.items:
            out.append({"seed": self.seed, "frame": k,
                        "radiance": (after - before).cpu().numpy(),
                        "accum": after.cpu().numpy(),
                        "display": np.asarray(host.cpu()).copy()})
        return out


DRIVERS = {"frames": Frames, "realtime": Realtime}


def make(cell, seed: int, device, mesh, settings=None,
         checked_frames: int = 1) -> Driver:
    """The driver of the cell's traffic; ``mesh`` is the configuration's,
    resolved (``meshes.resolve``)."""
    return DRIVERS[cell.traffic["driver"]](cell, seed, device, mesh,
                                           settings, checked_frames)
