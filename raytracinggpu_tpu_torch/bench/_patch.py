"""Functions of this package replaced for the length of a ``with`` block:
the one helper under the benchmarks' capture, plain-version patching and
record/replay."""
from __future__ import annotations

import contextlib
import importlib


def module(name: str):
    """The module ``raytracinggpu_tpu_torch.<name>`` (``"ops.sphere"``)."""
    return importlib.import_module(f"raytracinggpu_tpu_torch.{name}")


@contextlib.contextmanager
def patched(wrappers: dict):
    """Set each ``(module name, attribute)`` of ``wrappers`` to
    ``wrap(original)`` for its ``wrap``; every one is put back on exit, on
    an error too.  The package's modules look their callees up by name at
    each call, so a replaced function is what they call inside the block."""
    saved = []
    try:
        for (name, attr), wrap in wrappers.items():
            m = module(name)
            saved.append((m, attr, getattr(m, attr)))
            setattr(m, attr, wrap(saved[-1][2]))
        yield
    finally:
        for m, attr, fn in reversed(saved):
            setattr(m, attr, fn)
