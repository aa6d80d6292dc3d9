"""raytracinggpu_tpu_torch — the PyTorch + CUDA port of ``raytracinggpu_tpu``.

Each module sits at the same relative path as its JAX counterpart, so a
reader finds ``raytracinggpu_tpu/ops/pairs_trace.py`` ported in
``raytracinggpu_tpu_torch/ops/pairs_trace.py``.  Ported so far: the
``array_bvh`` preset (six wall spheres plus the cat mesh, or a custom OBJ
in the cat's place) and the ``realtime`` preset and loop, with the
``pairs``, ``pallas`` and ``dense`` mesh traversals and the reference and
LBVH builders.

- ``api.Renderer`` (exported here) and ``python -m
  raytracinggpu_tpu_torch.cli render``: the public entry points, on the
  CUDA device unless the caller asks for the CPU;
  ``bench/big_mesh.py``: a 200,000-triangle soup through them.

- ``core``: SoA ``Vec3`` over torch tensors, ``RayBatch``, and a threefry2x32
  counter PRNG that reproduces ``jax.random``'s bits.
- ``scene`` / ``accel``: the numpy host build (OBJ parse, reference
  midpoint BVH, the triangle, tiled and cluster-packed pairs tables) and
  the device tables.
- ``ops``: sphere intersection, the pairs and tiled cullings, the mesh
  queries whose inner loops are hand-written CUDA kernels
  (``csrc/pairs_trace.cu``, ``csrc/pallas_trace.cu``, built on first use
  by ``ops/_kernels.py``), and the dense matrix-product oracle.
- ``integrator`` / ``render``: the wavefront integrator, the frame
  pipeline and the realtime loop.
- ``parallel``: one frame across a (px, sp) mesh of ``torch.distributed``
  ranks, bitwise the single-device frame; the local launcher, the
  multi-process demo and the multichip dry run.
- ``convert``: carries the JAX package's host tables across (tests).

The package imports torch and numpy only: never jax, never
``raytracinggpu_tpu``.  Every builder takes an explicit ``device=``; a CPU
tensor runs each kernel's plain PyTorch version, a CUDA tensor launches the
kernel.
"""

__version__ = "0.1.0"

from raytracinggpu_tpu_torch.api import Renderer  # noqa: E402

__all__ = ["Renderer"]
