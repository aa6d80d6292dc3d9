"""raytracinggpu_tpu_torch — the PyTorch + CUDA port of ``raytracinggpu_tpu``.

Each module sits at the same relative path as its JAX counterpart, so a
reader finds ``raytracinggpu_tpu/ops/pairs_trace.py`` ported in
``raytracinggpu_tpu_torch/ops/pairs_trace.py``.  The slice ported so far is
the main render path: the ``array_bvh`` preset (six wall spheres plus the
cat mesh) rendered with ``traversal="pairs"``.

- ``core``: SoA ``Vec3`` over torch tensors, ``RayBatch``, and a threefry2x32
  counter PRNG that reproduces ``jax.random``'s bits.
- ``scene`` / ``accel``: the numpy host build (OBJ parse, reference
  midpoint BVH, cluster-packed pairs tables) and the device tables.
- ``ops``: sphere intersection, the pairs culling, and the two mesh
  queries whose inner loops are hand-written CUDA kernels
  (``csrc/pairs_trace.cu``, built on first use by ``ops/_kernels.py``).
- ``integrator`` / ``render``: the wavefront integrator and the frame
  pipeline.
- ``convert``: carries the JAX package's host tables across (tests).

The package imports torch and numpy only: never jax, never
``raytracinggpu_tpu``.  Every builder takes an explicit ``device=``; a CPU
tensor runs each kernel's plain PyTorch version, a CUDA tensor launches the
kernel.
"""

__version__ = "0.1.0"
