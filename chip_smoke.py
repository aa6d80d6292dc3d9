"""Drive the PyTorch + CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failed check exits nonzero:

1. environment: the card's name and power limit (nvidia-smi), torch,
   CUDA and nvcc versions;
2. build: compile the hand-written kernels (csrc/pairs_trace.cu: B0-B3,
   csrc/pallas_trace.cu: B5, B6, csrc/micro_kernel.cu: the probes B7a-e,
   csrc/cull.cu: the culling, pair_bits, compact_key, compact_bits (a
   compacted cast's rows and culling in one launch) and tile_lists,
   csrc/wavefront.cu: the depth step's sphere_hit, shade and bounce and
   the primary rays' primary_rays, csrc/glue.cu: the mesh casts'
   ray_rows and scatter and the trace's composite) with
   nvcc for sm_90a, one process per source, and load them;
3. per-cast check: render the main-path frame (array_bvh, 512x512,
   spp 32, depth 5) once with the compaction ladder off (every cast at
   full width, as in earlier versions of this script) while keeping the
   inputs the frame gives each kernel at depths 0 and 1 of its first cast
   (4 samples fused, 524,288 rays); on those inputs B1 and B2 must equal
   their plain PyTorch versions bit for bit, and so must B0, whose (t,
   idx) must also equal B1's on the closest casts;
4. headline frame: render the main-path frame through the public entry
   points (the default config: the ladder on) with the launch counters
   zeroed just before; the image and TraceStats must be finite and equal
   the phase-3 frame's (same seed), every ray must hit the
   enclosed scene at every depth, some shadow rays must be occluded, B1
   and B2 must have launched once per cast and B3 and B0 never, the
   culling once per cast (pair_bits at full width, compact_bits on a
   compacted cast) and compact_key once per cast at depth >= 1 (the
   ladder's key); then time three frames and print Mray/s.  Every other
   phase's launch counts leave the culling kernels out after holding them
   to the casts (pair_bits and compact_bits once per launch of B0-B3
   together, compact_key at most as often);
5. timings: each kernel against its plain version on the casts kept in
   phase 3, with ps a Moller-Trumbore test and the no-FMA floor (see
   NO_FMA_OPS_S) beside the bound;
6. production anchor: the 512x512 spp 8 depth 3 seed 0 frame's mean must
   lie within 1% of the JAX package's CPU render of the same frame; the
   JAX package's TPU record is printed beside it (see ANCHOR_* below);
7. realtime loop (the ``realtime`` preset, 512x512, spp 20, depth 3,
   seed 0; smooth normals, so every closest cast runs B3):
   a. the loop's first frame (``step`` from ``init_state``, the ladder
      off) with the inputs of B3's and B2's depth-0 and depth-1 casts
      kept; on them B3,
      B2 and B0 must equal their plain versions bit for bit, and B0's
      (t, idx) B3's; B3 must launch 30 times and B1 never;
   b. realtime anchor: the same frame through ``render_rows`` (the ladder
      on) must equal the step's frame, hit the enclosed scene with every
      ray at every
      depth, and its mean must lie within 1% of the JAX package's CPU
      render (ANCHOR_RT_* below);
   c. ``run_loop`` over LOOP_FRAMES frames with the counters zeroed just
      before: B3 launched 30 times a frame and B1 never; frames, rng_frame
      and the light angle advanced; the image finite; the last display
      the tonemap of the average; ms per frame (the call's wall time over
      its frames), FPS and Mray/s printed;
   d. checkpoint: save, load and step reproduce the uninterrupted next
      frame bit for bit;
   e. timings of B3 and B0 against their plain versions on the kept casts;
8. mesh query: ``intersect_tris_pairs(payload=None)``, the public query,
   on the realtime frame's primary rays with the counters zeroed: it must
   launch B0 once and give B3's (t, idx) on the same rays;
9. the tiled-kernel traversal (``traversal="pallas"``, csrc/pallas_trace.cu:
   B5 closest hit, B6 shadow):
   a. the headline frame with traversal="pallas", the inputs of B5's and
      B6's depth-0 and depth-1 casts kept; on them B5 and B6 must equal
      their plain versions bit for bit;
   b. the same frame again with the counters zeroed: finite, equal to the
      capture frame, every ray hits at every depth, some shadow rays
      occluded, B5 and B6 launched once per cast (and the tiled culling,
      tile_lists, once per cast of either) and B0-B3 never; three
      frames timed, Mray/s printed beside the pairs headline of phase 4;
   c. on the kept depth-0 rays with no cap: B5's (t, idx) through
      ``intersect_tris_pallas`` must equal B0's through
      ``intersect_tris_pairs(payload=None)``, and the dense oracle
      (``intersect_tris_dense``, full f32) must agree on hit/miss, t within
      rtol 1e-5 and idx on >= 99.9% of hits;
   d. the production anchor (phase 6) and the realtime frame 1 (phase 7b,
      smooth normals: the fused smooth-normal recovery runs) rendered
      through the pallas traversal, each mean within 1% of the JAX
      package's CPU render;
   e. B5 and B6 timed against their plain versions on the depth-1 casts,
      with the (subgroup, tile) visits and Moller-Trumbore tests of each
      cast, ps a test and the shares of the bound and of the no-FMA floor
      (B5 redesigned onto B6's merge walk, B6 as it was: the control);
10. the big-mesh path: bench/big_mesh.py's 200,000-triangle soup through
    ``Renderer("array_bvh", obj_path=..., bvh_builder="lbvh")`` at
    512x512, spp 4, depth 2, whose pairs table (2,053 tiles, 262,784
    slots) is past the 32,768 slots where the JAX package streams its
    field table in supertiles (B4, run here by B0-B3 over the whole
    table):
   a. the host build: its seconds, the tables' sizes and the subgroup;
   b. one frame (the ladder off) with the inputs of the depth-0 and
      depth-1 closest and shadow casts kept (524,288 rays each) and the
      peak device memory; on
      the busiest WINDOW_RAYS rays of each kept cast B1, B2 and B0 must
      equal their plain versions bit for bit, and so must B3 on a copy of
      the fields with seeded unit vertex normals (the soup has none); B0's
      and B3's (t, idx) must equal B1's;
   c. the frame again (the ladder on) with the counters zeroed: finite,
      equal to the capture frame, every ray hits at every depth, B1 and B2
      launched once per cast (BIG_CASTS each) and no other kernel; three
      frames timed, Mray/s printed;
   d. the same frame at ``pairs_subgroup=64`` (the soup's is 16) must
      equal it bit for bit; three frames timed, and B1 and B2 on the
      depth-1 casts of both subgroups, per Moller-Trumbore test;
   e. the same scene with ``traversal="pallas"`` (B5, B6): launches, the
      same hit and shadowed counts per depth, the image's largest
      difference from the pairs frame, three frames timed;
   f. the dense oracle on ORACLE_RAYS kept depth-0 rays, uncapped, against
      B1: t within rtol 1e-5 and idx equal on >= 99.9% of hits; hit/miss
      identical on >= 99.9% of the rays, and on every ray where it differs
      the deciding triangle lies within EDGE_MARGIN of its edge by the
      kernels' own arithmetic, which gives B1's answer (an edge graze that
      the oracle's matrix-product sums round the other way);
   g. B1 and B2 timed on the whole depth-1 casts against their bound, and
      on the casts' busiest windows (those of 10b) against their plain
      versions and the bound; the JSON line's ``pairs_b4`` entry holds the
      sums of both kernels' window numbers;
11. the probes (bench/micro_kernel.py, csrc/micro_kernel.cu: B7a tile
    slope, B7b mask in the kernel, B7c uniform branch, B7d row gather, B7e
    pair slope):
   a. at the entry point's defaults (PROBE_DEFAULT: 131,072 rays, 31
      tiles) and at the main path's cast size (PROBE_CAST: 524,288 rays,
      the cat's 40 tiles) every configuration of every probe (B7a at each
      L, B7b and its control, B7c under both masks, B7d, B7e at subgroups
      8, 16, 32, 64 and each L) must equal its plain version bit for bit;
   b. the entry point, ``bench.micro_kernel.main([])``, with the counters
      zeroed just before: every probe launched, no trace kernel; its
      timing tables (each case checked again inside; B7a's with the line
      through its times over L, the fixed cost of a cast and the cost of
      a visit), then the same tables at PROBE_CAST; the one PyTorch call
      that computes B7b (``torch.mul``) and B7d (``torch.index_select``)
      timed beside them at both sizes, on the same inputs, replayed from
      CUDA graphs as the kernels are;
12. the sweep and the last presets:
   a. ``bench.sweep.run_sweep`` on array_bvh 512x512, spps (8, 32) x
      bounces (3, 5), ``traversal="pairs"``, the counters zeroed just
      before: B1 and B2 launched once per cast of every frame, finite
      positive times, the (32, 5) cell's Mray/s beside the headline;
   b. one 512x512 spp 8 depth 5 frame of each of ``cpu``, ``global``,
      ``optimized`` and ``showcase``: finite, every ray hits at every
      depth (``cpu`` loses the few rays the JAX package loses there, see
      CPU_PRESET_HITS_FILE), B1 and B2 launched once per cast (no kernel for the
      mesh-less ``showcase``), Mray/s over two more frames; ``showcase``
      must send lanes through the mirror and refraction branches, and
      prints its total-internal-reflection lanes;
13. the animated mesh, the ``bvh`` traversal and the pairs clusterings
    (scene/transform.py, ops/bvh_traverse.py, accel/sah.py and the pave
    packing):
   a. ``run_loop`` of the ``realtime`` preset with ``animate_mesh`` over
      LOOP_FRAMES frames, the counters zeroed just before: B3 and B2
      launched 30 times a frame and B1 never, the mesh angle advanced by
      mesh_speed * dt a frame, the image finite; frame 2 from two
      ``step`` calls equals the loop's, and on its depth-0 and depth-1
      casts, which read the posed fields, B3, B2 and B0 must equal their
      plain versions bit for bit (and B0's (t, idx) B3's); ms a frame
      beside phase 7c's unanimated loop, and ``pose_mesh``'s ms between
      CUDA events, on the host clock and in device kernels (the busy
      share from a ``torch.profiler`` trace);
   b. animated anchor: frame 1 at mesh_speed ANIM_MESH_SPEED (0.9 rad)
      through pairs and through pallas, each mean within 1% of the JAX
      package's CPU render (ANCHOR_ANIM_CPU_MEAN);
   c. ``pose_mesh(rotation_y(POSE_ANGLE))`` of ``array_bvh`` against a
      scene built from host-rotated vertices, 512x512 spp 8 depth 3,
      through pairs and pallas: POSE_PIXEL_SHARE of the pixels within one
      u8 level; every posed vertex inside its pairs tile box, its member
      box and its tiled tile box; an identity pose bitwise the host-built
      tables;
   d. the production anchor through ``traversal="bvh"`` in the ``soa`` and
      ``aos10`` layouts: no kernel launched, every ray hits, each mean
      within 1% of the JAX package's CPU render, the two frames bitwise
      equal, each frame's seconds printed; on phase 3's depth-0 rays the
      walk against B0, uncapped: hit/miss and idx on >= 99.9% of the rays
      and hits, t within rtol 1e-5; the walk's host-clock time and its
      kernels' device time on those rays;
   e. the headline frame with the pairs tables of each ``--clustering``
      (ref, then CLUSTERINGS), the ladder off: bitwise phase 4's frame, B1
      and B2 launched once per cast; tiles, members, host build seconds
      and B1/B2 ms on the (whole) depth-1 cast of each;
14. multi-rank rendering (parallel/sharding.py): two ranks launched on
    this one card (``sharding.launch``, gloo: NCCL takes one rank a card),
    the kernels built by phase 2 before either starts:
   a. the headline frame on a (px 2, sp 1) mesh equals phase 4's frame bit
      for bit on every rank, and its world-summed TraceStats phase 4's; on
      every rank B1 and B2 launched once per cast of its own rows, B0, B3,
      B5 and B6 never;
   b. the same frame on a (px 1, sp 2) mesh equals phase 4's bit for bit;
   c. the production anchor through ``traversal="pallas"`` on (px 2,
      sp 1) equals phase 9d's frame bit for bit, B5 and B6 launched once
      per cast on every rank;
   d. ``python -m raytracinggpu_tpu_torch.cli render --devices 2`` exits
      nonzero naming 2 and the card count; with ``--device cpu`` at 8x8 it
      writes the PNG of ``--devices 1``;
   e. ``parallel.multihost_demo.dryrun_multichip`` on two ranks of the
      card, a (px 1, sp 2) mesh: its ``dense`` 256x256 spp 4 and ``pairs``
      64x64 spp 2 (SAH, pave) legs each bitwise the single-device frame;
   each case's wall time, each rank's render and exchange times and the
   bytes it hands to ``all_reduce`` are printed with the card: the two
   ranks time-slice one card, so the times are no scaling result.
15. the numpy oracle (oracle/numpy_ref.py, the cases of
    oracle/cases.py): the port's ``trace`` on the card, with injected
    uniforms, against the oracle's, a ray disagreeing past 3e-3 * |ref|
    + 3.0 in a channel: three random sphere scenes (seeds 7, 42, 1001,
    64x64, depth 4) under 4% of the rays, two random 200-triangle meshes
    (seeds 3, 99, 64x64) through ``pairs`` (B1, B2) and ``pallas`` (B5,
    B6) under 5%, the realtime config with smooth normals (32x32) through
    ``pairs`` (B3, B2) and ``pallas`` under 4%; each case's share and
    launches printed, each mesh case launching its kernels; the smooth
    normals' 32x32 frames through ``pallas`` and ``pairs`` against
    ``dense``: under 1% of the pixels off by more than 1e-4 * |dense| +
    2e-2;
16. the native host runtime (native.py): the library built from
    native/src/rt_native.cpp with g++ (or found built), its seconds and
    the compiler's version; with ``native=True`` against ``native=False``,
    bitwise: the cat OBJ with and without the embedded transform, the
    200,000-triangle soup's ``read_obj`` and its reference ``build_bvh``
    (seconds of each), the soup's host build through the Renderer
    (bench/big_mesh.py's ``host_build_s``) with ``RT_NATIVE=0`` and
    native (its tables equal), and phase 4's image written as a PNG, byte
    for byte the numpy writer's; it never fails on time;
17. the gallery: ``python -m raytracinggpu_tpu_torch.bench.gallery
    --quick`` in a process of its own, the frame rows ``array_bvh`` and
    ``showcase``, the realtime row ``realtime_512x512`` and the ablation
    rows ``pallas_tiled_s64``, ``spp_fuse1`` and ``bvh_skiplinks``: exit
    0, no error row, the card line in each file; the rows printed;
18. the compaction ladder (ops/pairs_trace.py: the default config's pairs
    casts at depth >= 1 run on their active rays only, packed into the
    tightest of three tiers that holds them, at full width when none
    does; the host reads each cast's active count):
   a. with the ladder on (the default) and off (every tier at 0), the
      counters zeroed before each: the headline frame, the realtime
      loop's frame 1, the animated loop's frame 1 and the soup frame
      (``pairs_key_coarse`` 32: its 2,053 tiles key as 65 boxes, key mode
      1) must be bitwise the same image with the same TraceStats, and
      launch B1 and B2 80 times (headline), B3 and B2 30 (realtime and
      animated), B1 and B2 4 (soup) both ways; per depth and query, the
      tiers each cast took and its active count over its rays;
   b. B1 and B2 on the headline's, B3 and B2 on the realtime frame's
      captured depth-1 and depth-2 casts with the ladder on (compacted
      where a tier held them) must equal their plain versions bit for
      bit; each timed against its plain version and its bound;
   c. the production, realtime and animated anchors (phases 6, 7b, 13b)
      ran with the ladder on.
   The ladder's times, on and off in turns (frames, kernel-device time,
   loops, each stage of a cast), are ``python -m
   raytracinggpu_tpu_torch.bench.ladder``'s, not this script's.
19. the culling kernels (csrc/cull.cu: ``pair_bits``, the per-subgroup
    active-tile bitmask of every full-width pairs cast, ``compact_bits``,
    the same words of a compacted cast's C rays with their rows, and
    ``compact_key``, the ladder's sort key and active count;
    ops/pairs_trace.py's ``_pair_bits``, ``compact_bits`` and
    ``_compact_key`` launch them on CUDA tensors):
   a. the inputs of the calls the frames make are kept (the headline with
      the ladder off: its depth-0 and depth-1 full-width casts; the
      headline and the realtime frame 1: the full-width casts of depth 0,
      the compacted casts of depths 1-2 and their keys; the soup: its
      depth-0 and depth-1 casts at subgroup 16, 65 words, and the keys
      over its 65 union boxes, mode 1); on each, the kernel must equal
      its plain version bit for bit (bits; rows, mask and bits; skey,
      n_act and shift);
   b. bench/cull.py's adversarial rays (65,536 rays, seeds 0 and 1:
      exactly-zero and -0.0 direction components, origins on box faces,
      zero-thickness boxes, caps at an enter distance) over 1,100 boxes
      in 300 tiles: pair_bits at subgroups 16, 32, 64 and the key over 40
      boxes (mode 2) and 1,100 (mode 1), with and without cap and active,
      bitwise;
   c. the headline frame (phase 4's), the realtime frame 1 and the soup
      frame must be bitwise (image and TraceStats) the same frames with
      the plain versions patched in for ``_pair_bits``, ``compact_bits``
      and ``_compact_key`` (the torch-op path), which launch no culling
      kernel and the same B0-B3;
   d. each kernel on the cat's depth-1 casts (full width; and pair_bits
      on a compacted cast's C rays, the rays compact_bits culls) and the
      soup's: its time replayed from a CUDA graph and eager, its
      plain version's, and the bound and no-FMA floor of bench/cull.py;
      the kernels a headline frame launches and their device time,
      through the kernels and with the plain culling
      (utils/profiling.device_kernels), and the frame's host-clock time
      both ways in turns (the kernels of an earlier tree beside these:
      ``python -m raytracinggpu_tpu_torch.bench.cull_design``);
   e. bench/cull.index_cases at 1,037 subgroups (subgroups 8 to 512, the
      rays no multiple of a block's, members naming tiles outside [0,
      nc), 5,000 tiles in several passes of a block's words at subgroups
      2 and 8, keys over 40, 129 and 1,100 boxes): each through the
      wrapper and at every rays-a-thread the kernels take
      (bench/cull_design.hold_index_cases), bitwise;
   f. compact_key is one device operation a call (no memset: one kernel
      node in a CUDA graph that captures a call), and its n_act equals the plain count over three calls in a row and
      two replays of one captured CUDA graph (the counter resets).
20. the tiled culling kernel (csrc/cull.cu: ``tile_lists``, the
    per-subgroup list rows [count, active tiles, inactive tiles] of every
    tiled cast: in one launch where a block holds its subgroups' words in
    one pass and the tile boxes in its shared memory (the cat's and the
    soup's casts), else in two (rt_pair_bits' kernel over the valid tile
    boxes, then one warp a row); ops/pallas_trace.py's
    ``_block_active_tiles`` launches it on CUDA tensors, as often as B5
    and B6 together, which _launched holds in every phase):
   a. the inputs of the calls the frames make are kept (the pallas
      headline's depth-0 and depth-1 closest and shadow casts, the soup's
      eight pallas casts over its 1,564 tiles, the posed first cast of
      the animated pallas frame 1); on each the kernel must equal its
      plain version bit for bit; so must it on bench/cull.py's adversarial
      tables (65,536 rays; 4, 31, 32, 33, 126, 127 and 300 tiles with the
      padding tiles' inverted boxes, NaN boxes and a box of infinite
      extent; subgroups 1-128; with and without cap) and on the tiled
      index cases at 1,037 subgroups (5,000 tiles in passes of a block's
      words, 140,000 tiles, every rays-a-thread;
      bench/cull_design.hold_index_cases); the frames' casts need no
      scratch (one launch), the tables past one pass of a block's words
      (140,000 tiles; 5,000 at subgroup 1) run in two, and the
      adversarial tables through two launches forced (rt_tile_lists_ko)
      give the same rows;
   b. the pallas headline frame and the soup pallas frame must be bitwise
      (image and TraceStats) the same frames with the plain version
      patched in for ``_block_active_tiles`` (the previous torch-op path),
      which launches no tile_lists and the same B5 and B6;
   c. the kernel on the pallas headline's depth-1 closest and shadow casts
      and the soup's depth-1 closest cast: its time replayed from a CUDA
      graph and eager, its plain version's, and the bound and no-FMA
      floor of bench/cull.py; the kernels a pallas headline frame
      launches and their device time both ways
      (utils/profiling.device_kernels); the pallas headline's and the
      soup pallas frame's host-clock time and Mray/s both ways in four
      rounds of turns (median and every frame), and the soup pallas
      frame's peak device memory both ways (the process's, and over what
      earlier phases hold).
21. the depth step's kernels (csrc/wavefront.cu: ``sphere_hit``, the
    nearest sphere of the closest and of the shadow rays; ``shade``, the
    merge with the mesh's hit, the materials and the shadow ray;
    ``bounce``, the occlusion, the direct term and the diffuse bounce;
    ``primary_rays``, a sample's uniforms and primary rays;
    bench/depth_step.py's tools), every launch counted in _launched:
   a. the inputs of each stage's calls at depths 0 and 1 of the first cast
      (samples 0 and 1) of the headline frame, the realtime frame 1, the
      animated frame 1, a ``showcase`` 512x512 spp 8 depth 5 frame, the
      pallas headline and the soup frame are kept; on each the kernel must
      equal its plain version bit for bit (NaNs as one value: a NaN's
      payload follows the instruction that carried it), and so must it on
      bench/depth_step.adversarial_calls' hard lanes (65,536 rays, seeds 0
      and 1, on the headline's, the showcase's and the realtime scene), and
      sphere_hit on bench/depth_step.sphere_edge_calls (the edges of its
      fast loop and its exact path, over those scenes' spheres, seed 0, 1
      and 2 in turn); then the
      identities its loop rests on hold over every f32 bit pattern
      (_kernels.f32_identities: sqrtf the f64 root rounded to f32; for x,
      x +- half its ulp and their neighbouring doubles, Veltkamp's split
      the f32 rounding and narrow24 its f32 wherever the loop accepts it);
   b. the headline, the realtime frame 1, the showcase frame and the
      pallas headline must be bitwise (image and TraceStats) the frames
      with the four plain stages patched in, which launch none of them;
   c. a headline frame's device operations (utils/profiling.device_kernels)
      in all, with its mesh casts replayed from a recording (what is left:
      the four kernels and the glue between them) and with its traces
      replayed (what is left: the primary rays and the per-sample glue),
      each replayed frame bitwise the recorded one; by wrapper and in
      total beside the parent's (PARENT_LAUNCHES); the glue at most
      DEPTH_STEP_GLUE a depth step and SAMPLE_GLUE a sample;
   d. each kernel on the headline's depth-1 calls (sample 1 for the
      primary rays): its time replayed from a CUDA graph and eager, its
      plain version's, its bound (bench/depth_step.call_bound) and what
      bounds it; and sphere_hit's loop from the built library's SASS (bench/
      sphere_scatter_design.sass_report: its instructions a lane and sphere
      by pipe and each pipe's time on the closest call; cuobjdump runs in
      a thread while a-c run), each of its kernels with a sphere loop free
      of F2F;
   e. the headline frame's and the realtime loop's wall times beside their
      device time (the union of the kernels' intervals) and busy share.
22. the mesh casts' glue and the trace's composite (csrc/glue.cu:
    ``ray_rows``, a full-width cast's ray-feature rows in the pairs, live
    and pallas layouts; ``scatter``, a compacted cast's outputs at full
    width in one launch; ``composite``, the backward composite; and
    csrc/cull.cu's ``compact_bits``, a compacted cast's rows from its
    sorted keys with their culling; bench/cast_glue.py's tools), every
    launch counted in _launched:
   a. the glue calls of the first trace's depths 0-2 and its composite in
      the headline, the realtime frame 1, the animated frame 1, the pallas
      headline, the soup (whose depth-1 casts overflow every tier) and
      the soup with a tier of GLUE_SOUP_TIER (key mode 1) are kept; on
      each the kernel must equal its plain version bit for bit (NaNs as
      one value), and so must it on bench/cast_glue.adversarial_calls
      (65,536 lanes of NaN, infinite, huge, zero, -0.0 and denormal rays
      in every layout, widths C = 0 to Rp, random bits scattered,
      composites of 1 to 17 depths), seeds 0 and 1;
   b. the headline, the realtime frame 1, the animated frame 1, the pallas
      headline, the soup and the headline with the ladder off must be
      bitwise (image and TraceStats) the frames with the four plain
      versions patched in, which launch none of them;
   c. a headline frame's device operations (utils/profiling.device_kernels)
      in all and with its mesh casts replayed, a pairs cast's (their
      difference over the 160 casts) beside the parent's (PARENT_OPS,
      PARENT_CAST_OPS), by wrapper; ray_rows + compact_bits one a pairs
      cast, scatter as often as compact_bits, composite one a trace, and
      the frame under half of PARENT_OPS; a compacted cast's device
      operations (the mesh casts' less FULL_CAST_OPS a full-width cast,
      over the compacted casts), the sort's (counted alone on keys of a
      cast's size, ``_sort_ops``: traced and from a CUDA graph, the larger)
      and COMPACTED_OWN_OPS more (the key, the count's copy
      to the host, compact_bits, the kernel, the scatter); every
      operation's name and count in both frames (what a cast launches is
      the difference);
   d. each kernel on the headline's casts (ray_rows on the depth-0
      closest cast, and in the live layout on the depth-1 closest cast's
      rays; compact_bits and scatter on the depth-1 closest and shadow
      casts; the first trace's composite): its time replayed from a CUDA
      graph, with the L2 emptied before each call and eager, its plain
      version's, its bound (bench/cast_glue.call_bound) and what bounds
      it, and for compact_bits torch.index_select of the live rows then
      rt_pair_bits on them;
   e. the headline, pallas headline and soup frames' and the realtime
      loop's wall times beside their device time and busy share, and
      bench/ladder.py's frames part (3 frames each way): the ladder's on /
      off ratio and the host's wait for the counts.

Each phase prints its wall time.  The next-to-last line is a JSON object
with one entry per kernel (its launches on the main path of its phase,
its largest error against the plain version, its time and the plain
version's on a whole depth-1 cast (the ladder off), and the bound: the larger of the cast's
Moller-Trumbore tests x FLOP_PER_TEST over PEAK_F32_FLOPS and the bytes
it must move over PEAK_BYTES_S; a probe's numbers are those of one
configuration at PROBE_DEFAULT, replayed from a CUDA graph, see
_PROBE_ROW; the culling kernels' are phase 19d's on the cat's depth-1
closest cast, full width, replayed from a CUDA graph, with their launches
in phase 4's frame, and tile_lists' phase 20c's on the pallas headline's
depth-1 closest cast with its launches in phase 9b's frame; the depth
step's are phase 21d's on the headline's depth-1 calls, with their
launches in phase 21c's headline frame; the glue's phase 22d's, ray_rows
on the depth-0 closest cast, compact_bits and scatter on the depth-1
closest cast, the composite on the first trace, with their launches in
phase 22c's headline frame (compact_bits' in phase 4's)); the last line
is the JSON result.
Without a CUDA device the script exits nonzero at once and prints no
result.  On its way out, passed or failed, it stops every process it
started that still runs, however deep (see _stop_leftovers), and fails
if one will not stop.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# Production anchor, 512x512 spp 8 depth 3 seed 0, array_bvh.  The JAX
# package's record (gallery/oracle_production_r05.jsonl, traversal "bvh")
# was rendered on a TPU, whose f32 rounding self-shadows more wall points
# (gallery/midres_platform_delta.json: array_bvh -3.5% against the CPU
# golden).  The check holds the port to the JAX package's CPU render of the
# same frame (render_rows in 32-row bands, traversal "pairs", mean of the
# f32 image in f64; PERF.md, "Production anchor", gives the command that
# prints it), and prints the TPU record beside it.
ANCHOR_TPU_MEAN = 102257.789
ANCHOR_CPU_MEAN = 104758.80389216123
ANCHOR_RTOL = 0.01
# Realtime anchor: frame 1 of the loop (realtime, 512x512, spp 20, depth 3,
# light at angle atan2(40, 0) + 0.02, key fold_in(PRNGKey(0), 0), the
# default quirk camera), the JAX package's CPU render in 32-row bands
# (PERF.md, "Realtime anchor", gives the command), same 1% limit.
ANCHOR_RT_CPU_MEAN = 74500.95069729118
LOOP_FRAMES = 6
# Phase 13b: frame 1 of the animated loop at mesh_speed 45 (the mesh at
# 45 * 0.02 = 0.9 rad, the light as in the realtime anchor), the JAX
# package's CPU render in 32-row bands (PERF.md, "Animated anchor", gives
# the command), same 1% limit.
ANCHOR_ANIM_CPU_MEAN = 74392.52495520844
ANIM_MESH_SPEED = 45.0
# Phase 13c: a pose on the device against a host rebuild of the rotated
# mesh (different trees, the same geometry): this share of pixels within
# one u8 level (tests/test_transform.py's standard)
POSE_ANGLE = 0.9
POSE_PIXEL_SHARE = 0.98
# Phase 13e: the pairs clusterings of the CLI's --clustering, each against
# the reference cut (pairs_cluster, pairs_pack, pairs_cut)
CLUSTERINGS = {"sah": ("sah", "morton", 0), "sah-pave": ("sah", "pave", 32),
               "ref-pave": ("ref", "pave", 32)}
# Phase 10: bench/big_mesh.py's soup; the JAX package streams a field
# table past ST_SLOTS slots in supertiles (B4); the plain versions are
# held on windows of WINDOW_RAYS rays of each cast (at the soup's 262,784
# slots they test every slot of 16 rays at a time), the dense oracle on
# ORACLE_RAYS
BIG_TRIS = 200_000
BIG_FRAME = dict(width=512, height=512, spp=4, max_depth=2)
BIG_CASTS = 4   # casts of each kernel in that frame: 2 depths x 2 chunks
ST_SLOTS = 32768
WINDOW_RAYS = 16384
ORACLE_RAYS = 8192
# a ray whose hit/miss differs between B1 and the dense oracle must graze
# an edge: the deciding barycentric within this of 0 (f32 rounding of
# O(1) sums in another order)
EDGE_MARGIN = 1e-5

# Phase 11: (rays, tiles) of the probe entry point's defaults and of the
# main path's casts (the cat's pairs tiles)
PROBE_DEFAULT = (131072, 31)
PROBE_CAST = (524288, 40)

# Phase 12: the `cpu` preset's scene is not quite closed to its own rays:
# in the frame phase 12b renders (512x512, spp 8, depth 5, seed 0) a few
# rays of 2,097,152 miss everything from depth 2 on.  The file records the
# lanes that lose them and the frame's hits at each depth; on the CPU
# tests/test_torch_presets.py renders every such lane through the JAX
# package and the port and requires the same losses.  The port must lose
# as many on the card, to HIT_RTOL of the rays.
CPU_PRESET_HITS_FILE = "tests/golden/cpu_512_lost_rays.json"
HIT_RTOL = 1e-5

# ptxas names the kernel templates' modes pairs_kernel<0..3>,
# tiled_kernel<false/true>, visit_kernel<false/true> (B7a, B7c),
# block_mask_kernel<false/true> and pair_slope_kernel<lanes a ray>
_MODES = {"pairs_kernelILi0E": "pairs_shadow",
          "pairs_kernelILi1E": "pairs_closest_idx",
          "pairs_kernelILi2E": "pairs_closest",
          "pairs_kernelILi3E": "pairs_closest_smooth",
          "tiled_kernelILb0E": "pallas_shadow",
          "tiled_kernelILb1E": "pallas_closest",
          "visit_kernelILb0E": "probe_tile_slope",
          "block_mask_kernelILb1E": "probe_block_mask",
          "block_mask_kernelILb0E": "probe_block_mask (control)",
          "visit_kernelILb1E": "probe_uniform_branch",
          "row_gather_kernel": "probe_row_gather",
          "pair_slope_kernelILi1E": "probe_pair_slope (subgroup >= 32)",
          "pair_slope_kernelILi2E": "probe_pair_slope (subgroup 16)",
          "pair_slope_kernelILi4E": "probe_pair_slope (subgroup 8)",
          "pair_slope_kernelILi8E": "probe_pair_slope (subgroup 4)",
          "pair_slope_kernelILi16E": "probe_pair_slope (subgroup 2)",
          "pair_slope_kernelILi32E": "probe_pair_slope (subgroup 1)",
          "pair_bits_kernelILi1ELb1E": "compact_bits (1 ray a thread)",
          "pair_bits_kernelILi2ELb1E": "compact_bits (2 rays a thread)",
          "pair_bits_kernelILi1ELb0ELb1E": "tile_lists (one launch, k 1)",
          "pair_bits_kernelILi2ELb0ELb1E": "tile_lists (one launch, k 2)",
          "pair_bits_kernelILi4ELb0ELb1E": "tile_lists (one launch, k 4)",
          "pair_bits_kernel": "pair_bits (and tile_lists' words)",
          "compact_key_kernel": "compact_key",
          "tile_lists_fused_kernel": "tile_lists (persistent variant)",
          "tile_lists_kernel": "tile_lists (rows)",
          "sphere_kernelILb1E": "sphere_hit (closest)",
          "sphere_kernelILb0E": "sphere_hit (shadow)",
          "shade_kernel": "shade", "bounce_kernel": "bounce",
          "primary_kernel": "primary_rays",
          "rows_kernel": "ray_rows",
          "scatter_kernel": "scatter", "composite_kernel": "composite"}
# (source, the TPU kernel it replaces) per kernel
_PAIRS = ("raytracinggpu_tpu_torch/csrc/pairs_trace.cu",
          "raytracinggpu_tpu/ops/pairs_trace.py:513")
_MICRO = "raytracinggpu_tpu_torch/csrc/micro_kernel.cu"
_CULL = "raytracinggpu_tpu_torch/csrc/cull.cu"
_WAVEFRONT = "raytracinggpu_tpu_torch/csrc/wavefront.cu"
_GLUE = "raytracinggpu_tpu_torch/csrc/glue.cu"
_ORIGIN = {
    "pairs_closest": _PAIRS, "pairs_shadow": _PAIRS,
    "pairs_closest_smooth": _PAIRS, "pairs_closest_idx": _PAIRS,
    "pallas_closest": ("raytracinggpu_tpu_torch/csrc/pallas_trace.cu",
                       "raytracinggpu_tpu/ops/pallas_trace.py:214"),
    "pallas_shadow": ("raytracinggpu_tpu_torch/csrc/pallas_trace.cu",
                      "raytracinggpu_tpu/ops/pallas_trace.py:310"),
    # B4, the JAX kernel's streamed-supertile grid: B1 and B2 past ST_SLOTS
    "pairs_b4": ("raytracinggpu_tpu_torch/csrc/pairs_trace.cu",
                 "raytracinggpu_tpu/ops/pairs_trace.py:784"),
    # XLA-side work in the JAX package (no Pallas kernel): the culling
    "pair_bits": (_CULL, "raytracinggpu_tpu/ops/pairs_trace.py:423 "
                  "_pair_bits with members (XLA-side, no Pallas kernel)"),
    "compact_key": (_CULL, "raytracinggpu_tpu/ops/pairs_trace.py:928 "
                    "_compact_key (XLA-side, no Pallas kernel)"),
    "tile_lists": (_CULL, "raytracinggpu_tpu/ops/pallas_trace.py:475 "
                   "_block_active_tiles (XLA-side, no Pallas kernel)"),
    "compact_bits": (_CULL, "raytracinggpu_tpu/ops/pairs_trace.py:994 "
                     "_compact_sort's lanes, the jnp.take of :1213, :1327 "
                     "and :423 _pair_bits with members on those rays "
                     "(XLA-side, no Pallas kernel)"),
    # the depth step's and the primary rays' math, XLA-side too
    "sphere_hit": (_WAVEFRONT, "raytracinggpu_tpu/ops/sphere.py:44 "
                   "intersect_spheres (XLA-side, no Pallas kernel)"),
    "shade": (_WAVEFRONT, "raytracinggpu_tpu/integrator/wavefront.py:103 "
              "intersect_all's merge and :276 _depth_step's shading "
              "(XLA-side, no Pallas kernel)"),
    "bounce": (_WAVEFRONT, "raytracinggpu_tpu/integrator/wavefront.py:276 "
               "_depth_step's occlusion and bounce, core/rng.py:66 "
               "cosine_hemisphere (XLA-side, no Pallas kernel)"),
    "primary_rays": (_WAVEFRONT, "raytracinggpu_tpu/render/pipeline.py:110 "
                     "row_uniforms and :128 raygen (XLA-side, no Pallas "
                     "kernel)"),
    # the mesh casts' glue and the backward composite, XLA-side too
    "ray_rows": (_GLUE, "raytracinggpu_tpu/ops/pairs_trace.py:386 "
                 "_ray_feature_rows and ops/pallas_trace.py:202 "
                 "_ray_features16 (XLA-side, no Pallas kernel)"),
    "scatter": (_GLUE, "raytracinggpu_tpu/ops/pairs_trace.py:1228, :1334 "
                ".at[src].set (XLA-side, no Pallas kernel)"),
    "composite": (_GLUE, "raytracinggpu_tpu/integrator/wavefront.py:413 "
                  "the backward composite's jax.lax.scan (XLA-side, no "
                  "Pallas kernel)"),
    "probe_tile_slope": (_MICRO, "raytracinggpu_tpu/bench/micro_kernel.py:75"),
    "probe_block_mask": (_MICRO,
                         "raytracinggpu_tpu/bench/micro_kernel.py:128"),
    "probe_uniform_branch": (_MICRO,
                             "raytracinggpu_tpu/bench/micro_kernel.py:189"),
    "probe_row_gather": (_MICRO,
                         "raytracinggpu_tpu/bench/micro_kernel.py:233"),
    "probe_pair_slope": (_MICRO,
                         "raytracinggpu_tpu/bench/micro_kernel.py:312"),
}
# The configuration of each probe that the JSON line reports, at
# PROBE_DEFAULT: (key of bench.micro_kernel.main's result, its case)
_PROBE_ROW = {
    "probe_tile_slope": ("slope", dict(L=8)),
    "probe_block_mask": ("dma", None),
    "probe_uniform_branch": ("branch", dict(name="all_true")),
    "probe_row_gather": ("gather", None),
    "probe_pair_slope": ("pairslope", dict(subg=64, L=4)),
}
# The bound of a kernel (peak rates from NVIDIA's H100 SXM data
# sheet): f32 outside the tensor cores, and device memory.  One
# Moller-Trumbore test is 39 f32 operations: 21 multiplies, 17 adds and
# subtractions, one reciprocal (the 5 comparisons are not counted).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
FLOP_PER_TEST = 39
# The peak counts an FMA as two operations; the kernels are built without
# FMA (bitwise their plain versions), so each of a test's 39 operations
# issues alone: the floor of the pairs kernels is the tests' operations
# at half the peak
NO_FMA_OPS_S = PEAK_F32_FLOPS / 2


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def _adopt_orphans() -> None:
    """Make this process the parent of every process it starts, however
    deep, once that process's own parent has exited (Linux
    PR_SET_CHILD_SUBREAPER), so that ``_stop_leftovers`` finds them."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:  # PR_SET_CHILD_SUBREAPER
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _descendants() -> dict:
    """pid -> command line of every live (not zombie) process below this
    one, from /proc."""
    parent, cmd = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat", "rb") as f:
                stat = f.read()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                line = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:  # exited while being read
            continue
        state, ppid = stat[stat.rfind(b")") + 2:].split()[:2]
        if state != b"Z":
            parent[int(d)], cmd[int(d)] = int(ppid), line.strip()
    found, frontier = set(), {os.getpid()}
    while frontier:
        frontier = {p for p, pp in parent.items() if pp in frontier} - found
        found |= frontier
    return {p: cmd[p] for p in sorted(found)}


def _reap() -> None:
    """Collect the exit status of every child that has exited."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def _stop_leftovers() -> None:
    """Stop every process this one started that still runs: the
    multiprocessing resource tracker that spawned ranks leave behind (it
    exits when this process closes its pipe), then anything else, with
    SIGTERM and after 5 s SIGKILL, each named on stderr.  Raises
    SystemExit if one is still running after that."""
    import signal
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_fd", None) is not None:
        os.close(tracker._fd)
        tracker._fd = None
    for sig in (signal.SIGTERM, signal.SIGKILL, None):
        deadline = time.monotonic() + 5.0
        while True:
            _reap()
            left = _descendants()
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if not left:
            return
        if sig is None:
            raise SystemExit("chip_smoke: FAIL: processes still running: "
                             f"{left}")
        for pid, line in left.items():
            print(f"chip_smoke: {sig.name} to leftover process {pid}: "
                  f"{line}", file=sys.stderr)
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass


# B0-B3: each launch is one pairs cast, which culls once (pair_bits)
_PAIRS_KERNELS = ("pairs_closest", "pairs_shadow", "pairs_closest_smooth",
                  "pairs_closest_idx")


def _launched(culling: dict | None = None, depth: dict | None = None,
              glue: dict | None = None) -> dict:
    """The launches since the last ``reset_launches()``, by kernel, without
    the culling kernels of csrc/cull.cu, the depth step's of
    csrc/wavefront.cu and the glue's of csrc/glue.cu, which are held here:
    every pairs cast culls once, at full width (pair_bits) or compacted
    (compact_bits, its rows too), so those two launched as often as B0-B3
    together, and the ladder keys at most every cast (compact_key); every
    tiled cast culls once, so tile_lists launched as often as B5 and B6
    together; every depth step runs the sphere pass twice, the shading and
    the bounce once; every cast builds its rows once, at full width
    (ray_rows) or compacted (compact_bits, then scatter), and every trace
    composes once (at most one composite a shading, one for some).
    ``culling``, ``depth`` and ``glue`` receive their counts."""
    from raytracinggpu_tpu_torch.ops import _kernels

    out = dict(_kernels.LAUNCHES)
    cull = {k: out.pop(k) for k in _kernels.CULLING}
    step = {k: out.pop(k) for k in _kernels.DEPTH_STEP}
    rows = {k: out.pop(k) for k in _kernels.GLUE}
    casts = sum(out[k] for k in _PAIRS_KERNELS)
    tiled = out["pallas_closest"] + out["pallas_shadow"]
    if cull["pair_bits"] + cull["compact_bits"] != casts \
            or not 0 <= cull["compact_key"] <= casts \
            or cull["tile_lists"] != tiled:
        _fail(f"culling launches {cull} for {casts} pairs casts and "
              f"{tiled} tiled casts")
    if step["sphere_hit"] != 2 * step["shade"] \
            or step["bounce"] != step["shade"]:
        _fail(f"depth-step launches {step}: the sphere pass not twice, or "
              "the bounce not once, a shading")
    composed = (0 < rows["composite"] <= step["shade"] if step["shade"]
                else not rows["composite"])
    if rows["ray_rows"] + cull["compact_bits"] != casts + tiled \
            or rows["scatter"] != cull["compact_bits"] or not composed:
        _fail(f"glue launches {rows} for {casts} pairs casts, {tiled} tiled "
              f"casts and {step['shade']} shadings: the rows not once a "
              "cast, a compacted cast not scattered once, or no composite "
              "for the traces")
    if culling is not None:
        culling.update(cull)
    if depth is not None:
        depth.update(step)
    if glue is not None:
        glue.update(rows)
    return out


def _none() -> dict:
    """No launch of any kernel but the culling, depth-step and glue ones
    (see _launched)."""
    from raytracinggpu_tpu_torch.ops import _kernels

    return {k: 0 for k in _kernels.LAUNCHES
            if k not in _kernels.CULLING + _kernels.DEPTH_STEP
            + _kernels.GLUE}


def _ladder_off(cfg):
    """``cfg`` with every tier of the compaction ladder at 0: each pairs
    cast at full width (the frame is the same)."""
    from raytracinggpu_tpu_torch.bench.ladder import ladder_off

    return ladder_off(cfg)


class _Laps:
    """Prints each phase's wall time as it ends: the time since the
    previous phase ended."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self, name: str) -> None:
        t = time.perf_counter()
        print(f"phase {name}: {t - self.t0:.2f} s", flush=True)
        self.t0 = t


def _card_line() -> str:
    from raytracinggpu_tpu_torch.bench._timing import card_line

    try:
        return card_line()
    except RuntimeError as e:
        _fail(str(e))


def _time_ms(fn, iters: int, graph: bool = False,
             flush_l2: bool = False) -> float:
    """Mean device time of fn over iters launches (CUDA events), after one
    warm-up call; ``graph``: the launches replayed from one CUDA graph
    (see bench/_timing.timed), the kernels without the host's launch
    cost; ``flush_l2``: the L2 emptied of fn's inputs before each call."""
    from raytracinggpu_tpu_torch.bench._timing import timed

    return timed(fn, iters, graph=graph, flush_l2=flush_l2) * 1e3


def _max_abs_err(a, b) -> float:
    import torch

    if torch.equal(a, b):
        return 0.0
    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=math.inf).max())


def _mt_tests(kernel, args) -> tuple[int, int]:
    """(subgroup, tile) visits and Moller-Trumbore tests of one cast, from
    its culling input: a ray tests every slot of every tile its subgroup
    keeps (set bits of the pairs bitmask, the count of a tiled list)."""
    import torch

    subg = args[4]
    if kernel.startswith("pallas"):
        visits = int(args[2][:, 0].clamp_min(0).sum())
        tile_t = 128
    else:
        w = args[2].to(torch.int64) & 0xFFFFFFFF
        visits = int(sum(int(((w >> b) & 1).sum()) for b in range(32)))
        tile_t = args[5]
    return visits, visits * tile_t * subg


def _bound(kernel, args, outs) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the cast's operations over the
    f32 peak and the bytes it must move (the 9 ray-feature rows and the
    field rows read once, the culling input read once, the outputs written
    once) over the memory rate."""
    from raytracinggpu_tpu_torch.ops import _kernels

    rfT, fields, cull = args[:3]
    field_rows = _kernels._SPECS[kernel][1]
    nbytes = (9 * rfT.shape[1] + field_rows * fields.shape[1]) * 4 \
        + cull.numel() * 4 + sum(o.numel() * o.element_size() for o in outs)
    ops_s = _mt_tests(kernel, args)[1] * FLOP_PER_TEST / PEAK_F32_FLOPS
    bytes_s = nbytes / PEAK_BYTES_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _capture_casts(render, per_kernel: int):
    """Run render() with each kernel's launch wrapper wrapped so that the
    inputs of its first ``per_kernel`` launches are kept.  The wrapped
    function is the real wrapper, which launches and counts as always; the
    originals are put back afterwards.  Returns ({kernel: [(rfT, culling
    input), ...]} in launch order, render's result)."""
    from raytracinggpu_tpu_torch.ops import _kernels

    kept = {k: [] for k in _kernels._SPECS}  # the trace kernels
    orig = {k: getattr(_kernels, k) for k in kept}

    def keeping(k):
        def launch(rfT, fields, bits, *rest):
            if len(kept[k]) < per_kernel:
                kept[k].append((rfT.clone(), bits.clone()))
            return orig[k](rfT, fields, bits, *rest)
        return launch

    for k in kept:
        setattr(_kernels, k, keeping(k))
    try:
        out = render()
    finally:
        for k, f in orig.items():
            setattr(_kernels, k, f)
    return kept, out


def _busiest_window(bits, subg: int, n: int) -> int:
    """First ray of the n-ray window of whole subgroups whose culling
    bitmask sets the most (subgroup, tile) bits."""
    import torch

    w = bits.to(torch.int64) & 0xFFFFFFFF
    per_sg = sum(((w >> b) & 1).sum(dim=0) for b in range(32))
    c = torch.cumsum(per_sg, 0)
    k = n // subg
    sums = c[k - 1:] - torch.cat([c.new_zeros(1), c[:-k]])
    return int(sums.argmax()) * subg


def _window(rfT, bits, subg: int, n: int):
    """(rfT, bits) of the busiest n-ray window of a cast (see
    _busiest_window), contiguous, and the window's first ray."""
    a = _busiest_window(bits, subg, n)
    return (rfT[:, a:a + n].contiguous(),
            bits[:, a // subg:(a + n) // subg].contiguous(), a)


def _check_casts(kept, plan, tab, cfg, err, label, fields=None, window=None,
                 depths=(0, 1)):
    """Hold each kept cast's kernel bitwise against its plain version on
    the cast's inputs.  ``plan`` maps a captured kernel to the closest-hit
    kernels that run on its casts too (B0 on a closest cast), which must
    also equal their plain versions and give the captured kernel's (t,
    idx).  ``fields`` replaces the table's field rows; ``window`` holds
    the kernels on the busiest ``window`` rays of each cast instead of all
    of them; ``depths`` names the kept casts.  Adds to ``err`` {kernel:
    max abs error}; returns the casts as [(name, depth, kernels, args)]."""
    import torch
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    casts = []
    for kname, extra in plan.items():
        if len(kept[kname]) != len(depths):
            _fail(f"{kname}: captured {len(kept[kname])} casts, expected "
                  f"{len(depths)}")
        for depth, (rfT, bits) in zip(depths, kept[kname]):
            name = f"{label} depth{depth} {kname}"
            if window:
                n_rays = rfT.shape[1]
                rfT, bits, a = _window(rfT, bits, cfg.pairs_subgroup, window)
                name += (f" rays [{a}, {a + window}) of {n_rays} (the "
                         "busiest window)")
            args = (rfT, tab.fields if fields is None else fields, bits,
                    cfg.eps_leaf, cfg.pairs_subgroup, pt.tile_width(tab))
            outs = {}
            for k in (kname, *extra):
                got = getattr(_kernels, k)(*args)
                want = getattr(pt, f"{k}_plain")(*args)
                if k == "pairs_shadow":
                    got, want = (got,), (want,)
                torch.cuda.synchronize()
                e = max(_max_abs_err(a, b) for a, b in zip(got, want))
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                if k == kname:
                    hits = int((want[0] < pt.INF32).sum())
                    pairs = int(sum(bin(int(w) & 0xFFFFFFFF).count("1")
                                    for w in bits.flatten().tolist()))
                    print(f"cast {name}: rfT {tuple(rfT.shape)}, bits "
                          f"{tuple(bits.shape)}, {hits} mesh hits, {pairs} "
                          f"(subgroup, tile) pairs")
                print(f"  {k} vs plain: "
                      f"{'bitwise equal' if same else f'DIFFER (max abs {e})'}")
                if not same:
                    _fail(f"{k} differs from its plain version on {name}")
                err[k] = max(err[k], e)
                outs[k] = got
            for k in extra:
                if not all(torch.equal(a, b) for a, b in
                           zip(outs[k][:2], outs[kname][:2])):
                    _fail(f"{k}'s (t, idx) differ from {kname}'s on {name}")
                print(f"  {k} (t, idx) == {kname} (t, idx)")
            casts.append((name, depth, (kname, *extra), args))
    return casts


def _time_casts(casts, timing, card, depths=(0, 1)):
    """Time every kernel of the casts at ``depths`` against its plain
    version; keeps the depth-1 times and bound in ``timing`` {kernel:
    (ms, plain_ms, bound_ms, bound_by)}."""
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    for name, depth, kernels, args in casts:
        if depth not in depths:
            continue
        for k in kernels:
            kern = getattr(_kernels, k)
            plain = getattr(pat if k.startswith("pallas") else pt,
                            f"{k}_plain")
            ms = _time_ms(lambda: kern(*args), 20)
            plain_ms = _time_ms(lambda: plain(*args), 3)
            out = kern(*args)
            bound_ms, bound_by = _bound(k, args,
                                        out if isinstance(out, tuple)
                                        else (out,))
            visits, tests = _mt_tests(k, args)
            floor_ms = tests * FLOP_PER_TEST / NO_FMA_OPS_S * 1e3
            if depth == 1:
                timing[k] = (ms, plain_ms, bound_ms, bound_by)
            print(f"timing {k} on the {name} cast ({args[0].shape[1]} "
                  f"rays, {visits} (subgroup, tile) visits, {tests} MT "
                  f"tests): kernel {ms:.4f} ms, {ms * 1e9 / tests:.3f} ps a "
                  f"test, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; roofline share {bound_ms / ms:.1%}), no-FMA "
                  f"floor {floor_ms:.4f} ms ({floor_ms / ms:.1%}) on {card}")


def _realtime(device, card, err, timing):
    """Phase 7 (module docstring).  Returns the loop's launch counts, its
    ms a frame and, for phase 8, (config, scene tables, kept casts)."""
    import io
    import tempfile

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.core.rng import PRNGKey, fold_in
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.render.image_io import tonemap
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, chunk_size, group_size, rays_per_frame, render_rows)
    from raytracinggpu_tpu_torch.scene.presets import build_preset
    from raytracinggpu_tpu_torch.utils.checkpoint import load_state, save_state

    t0 = time.perf_counter()
    cfg, tables = build_preset("realtime", device)
    torch.cuda.synchronize()
    W, H, spp = cfg.width, cfg.height, cfg.spp
    g = group_size(cfg, spp)
    per_frame = (spp // g) * cfg.max_depth * -(-g * W * H
                                               // chunk_size(cfg, g * W * H))
    print(f"scene: realtime {W}x{H} spp {spp} depth {cfg.max_depth}, smooth "
          f"normals {cfg.smooth_normals}, {per_frame} closest casts a frame, "
          f"built in {time.perf_counter() - t0:.2f} s")
    if ((W, H, spp, cfg.max_depth, per_frame) != (512, 512, 20, 3, 30)
            or not cfg.smooth_normals):
        _fail("the realtime preset is not 512x512 spp 20 depth 3 with smooth "
              "normals and 30 closest casts a frame")
    want = lambda n: {**_none(),
                      "pairs_closest_smooth": n * per_frame,
                      "pairs_shadow": n * per_frame}

    # a. the first frame, casts kept (the ladder off: whole casts; b holds
    # the default frame to it)
    state0 = rt.init_state(cfg, tables, seed=0)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    kept, (state1, disp1) = _capture_casts(
        lambda: rt.step(tables, _ladder_off(cfg), state0), 2)
    torch.cuda.synchronize()
    first = _launched()
    print(f"realtime frame 1 (casts kept, the ladder off): "
          f"{time.perf_counter() - t0:.3f} s, launches {first}")
    if first != want(1):
        _fail(f"realtime frame 1 launches {first}, expected {want(1)}")
    casts = _check_casts(kept, {"pairs_closest_smooth": ("pairs_closest_idx",),
                                "pairs_shadow": ()},
                         tables.pairs_mesh, cfg, err, "realtime")

    # b. realtime anchor: frame 1 through render_rows
    angle0 = np.float32(np.arctan2(float(tables.L.z), float(tables.L.x)))
    angle1 = np.float32(angle0 + np.float32(0.02))
    if float(state1.light_angle) != float(angle1):
        _fail(f"frame 1 light angle {float(state1.light_angle)} != {angle1}")
    acc, stats = render_rows(rt.orbit_light(tables, angle1), cfg,
                             Camera.default(cfg, device),
                             fold_in(PRNGKey(0, device), 0),
                             np.arange(H, dtype=np.int32), range(spp))
    img = torch.stack([(c / float(spp)).reshape(H, W) for c in acc], dim=-1)
    hit = stats.hit.tolist()
    mean = float(img.double().mean())
    rel = (mean - ANCHOR_RT_CPU_MEAN) / ANCHOR_RT_CPU_MEAN
    print(f"realtime anchor: frame 1 mean {mean:.3f} vs the JAX package on "
          f"CPU {ANCHOR_RT_CPU_MEAN:.3f} (rel {rel:+.6f}, limit "
          f"{ANCHOR_RTOL}); hit per depth {hit}, shadowed "
          f"{stats.shadowed.tolist()}")
    if not torch.equal(img, state1.accum):
        _fail("render_rows of frame 1 (the ladder on) differs from the "
              "loop's frame 1 (the ladder off)")
    if any(h != W * H * spp for h in hit):
        _fail(f"rays escaped the realtime scene: hit {hit} != {W * H * spp}")
    if int(stats.shadowed.sum()) <= 0:
        _fail("no shadow ray was occluded in the realtime frame")
    if not abs(rel) <= ANCHOR_RTOL:
        _fail(f"realtime anchor mean {mean} off by {rel:.4%}")

    # c. the loop
    # run_loop's own mean skips the first frame, whose time also holds the
    # enqueue of frame 2; the whole call's wall time over the frame count
    # is the rate the loop sustains, and is the one reported
    pipe = io.BytesIO()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    state, summary = rt.run_loop(tables, cfg, LOOP_FRAMES, seed=0,
                                 raw_pipe=pipe, print_every=0)
    torch.cuda.synchronize()
    frame_s = (time.perf_counter() - t0) / LOOP_FRAMES
    loop_launches = _launched()
    print(f"realtime loop: {LOOP_FRAMES} frames, {frame_s * 1e3:.3f} ms per "
          f"frame, {1 / frame_s:.3f} FPS, "
          f"{rays_per_frame(cfg) / frame_s / 1e6:.3f} Mray/s "
          f"({rays_per_frame(cfg)} rays a frame; run_loop's own mean "
          f"{summary['mean_ms']:.3f} ms, first frame "
          f"{summary['first_frame_ms']:.3f} ms), launches {loop_launches}, "
          f"on {card}")
    if loop_launches != want(LOOP_FRAMES):
        _fail(f"loop launches {loop_launches}, expected "
              f"{want(LOOP_FRAMES)}")
    angle = angle0
    for _ in range(LOOP_FRAMES):
        angle = np.float32(angle + np.float32(0.02))
    got = (int(state.frames), int(state.rng_frame), float(state.light_angle))
    if got != (LOOP_FRAMES, LOOP_FRAMES, float(angle)):
        _fail(f"loop state (frames, rng_frame, light angle) {got}, expected "
              f"{(LOOP_FRAMES, LOOP_FRAMES, float(angle))}")
    if not bool(torch.isfinite(state.accum).all()):
        _fail("realtime image has non-finite values")
    shown = np.frombuffer(pipe.getvalue(), np.uint8).reshape(
        LOOP_FRAMES, H, W, 3)
    if not np.array_equal(shown[0], disp1.cpu().numpy()):
        _fail("the loop's first display differs from frame 1's")
    avg = (state.accum / state.frames.to(torch.float32)).cpu().numpy()
    if not np.array_equal(shown[-1], tonemap(avg)):
        _fail("the last display is not the tonemap of the average")

    # d. checkpoint: save, load and step == the uninterrupted next frame
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        save_state(path, state)
        resumed = load_state(path, device)
    a, disp_a = rt.step(tables, cfg, resumed)
    b, disp_b = rt.step(tables, cfg, state)
    if not (torch.equal(a.accum, b.accum) and torch.equal(disp_a, disp_b)
            and int(a.frames) == LOOP_FRAMES + 1):
        _fail("a resumed checkpoint stepped to another frame")
    print(f"checkpoint: frame {LOOP_FRAMES + 1} after save/load is bitwise "
          "the uninterrupted one")

    # e. timings on the kept casts
    _time_casts(casts, timing, card)
    return loop_launches, frame_s * 1e3, (cfg, tables, casts)


def _mesh_query(cfg, tables, casts, err):
    """Phase 8 (module docstring): the public payload-less query on the
    primary rays of the realtime frame's first cast.  Returns its launch
    counts."""
    import torch
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    rfT = next(args[0] for _, depth, ks, args in casts
               if depth == 0 and ks[0] == "pairs_closest_smooth")
    u = Vec3(*(rfT[i].clone() for i in (0, 1, 2)))   # rfT rows: u, O x u, O
    O = Vec3(*(rfT[i].clone() for i in (6, 7, 8)))
    tab = tables.pairs_mesh
    kw = dict(subg=cfg.pairs_subgroup, blk=cfg.pairs_block)
    _kernels.reset_launches()
    hit = pt.intersect_tris_pairs(O, u, tab, cfg.eps_leaf, payload=None, **kw)
    torch.cuda.synchronize()
    launches = _launched()
    expected = _none()
    expected["pairs_closest_idx"] = 1
    print(f"mesh query: {O.x.shape[0]} primary rays, "
          f"{int((hit.t < pt.INF32).sum())} mesh hits, launches {launches}")
    if launches != expected:
        _fail(f"mesh query launches {launches}, expected {expected}")
    smooth, _ = pt.intersect_tris_pairs(O, u, tab, cfg.eps_leaf,
                                        payload="smooth", **kw)
    rf, bits, R = pt.cast_inputs(O, u, tab, **kw)
    plain = pt.pairs_closest_idx_plain(rf, tab.fields, bits, cfg.eps_leaf,
                                       cfg.pairs_subgroup, pt.tile_width(tab))
    for a, b, what in ((hit.t, plain[0][:R], "plain t"),
                       (hit.idx, plain[1][:R], "plain idx"),
                       (hit.t, smooth.t, "B3's t"),
                       (hit.idx, smooth.idx, "B3's idx")):
        e = _max_abs_err(a, b)
        err["pairs_closest_idx"] = max(err["pairs_closest_idx"], e)
        if not torch.equal(a, b):
            _fail(f"mesh query: B0 differs from {what} (max abs {e})")
    print("mesh query: B0 bitwise equal to its plain version and to B3's "
          "(t, idx)")
    return launches


def _pallas(device, card, err, timing, pairs_mrays):
    """Phase 9 (module docstring).  Returns the headline frame's launch
    counts and 9d's production-anchor frame."""
    import dataclasses

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.core.rng import PRNGKey, fold_in
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat
    from raytracinggpu_tpu_torch.ops.triangle import intersect_tris_dense
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, chunk_size, group_size, rays_per_frame, render_frame,
        render_rows)
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    # a. the capture frame
    t0 = time.perf_counter()
    cfg, tables = build_preset("array_bvh", device, width=512, height=512,
                               spp=32, max_depth=5, traversal="pallas")
    torch.cuda.synchronize()
    tab = tables.pallas_mesh
    print(f"scene: array_bvh pallas, {tab.n_tiles} tiles of {pat.TILE_T} "
          f"triangles, subgroup {cfg.pallas_subgroup}, ray sort "
          f"{cfg.ray_sort}, built in {time.perf_counter() - t0:.2f} s")
    cam = Camera.default(cfg, device)
    g = group_size(cfg, cfg.spp)
    R_group = g * cfg.width * cfg.height
    chunk = chunk_size(cfg, R_group, "pallas")
    n_casts = (cfg.spp // g) * cfg.max_depth * -(-R_group // chunk)
    t0 = time.perf_counter()
    kept, (cap_img, _) = _capture_casts(
        lambda: render_frame(tables, cfg, cam, PRNGKey(0, device)), 2)
    torch.cuda.synchronize()
    print(f"pallas capture frame: {time.perf_counter() - t0:.3f} s; casts "
          f"of {chunk} rays")
    casts = []
    for k in ("pallas_closest", "pallas_shadow"):
        if len(kept[k]) != 2:
            _fail(f"{k}: captured {len(kept[k])} casts, expected 2")
        for depth, (rfT, lists) in enumerate(kept[k]):
            args = (rfT, tab.fields, lists, cfg.eps_leaf,
                    cfg.pallas_subgroup)
            got = getattr(_kernels, k)(*args)
            want = getattr(pat, f"{k}_plain")(*args)
            if k == "pallas_shadow":
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            e = max(_max_abs_err(a, b) for a, b in zip(got, want))
            err[k] = max(err[k], e)
            visits, tests = _mt_tests(k, args)
            print(f"cast pallas depth{depth} {k}: rfT {tuple(rfT.shape)}, "
                  f"lists {tuple(lists.shape)}, "
                  f"{int((want[0] < pat.INF32).sum())} mesh hits, {visits} "
                  f"(subgroup, tile) visits, {tests} MT tests; vs plain: "
                  f"{'bitwise equal' if e == 0.0 else f'DIFFER ({e})'}")
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                _fail(f"{k} differs from its plain version at depth {depth}")
            casts.append((f"pallas depth{depth}", depth, (k,), args))

    # b. the headline frame through the pallas traversal
    _kernels.reset_launches()
    t0 = time.perf_counter()
    img, stats = render_frame(tables, cfg, cam, PRNGKey(0, device))
    torch.cuda.synchronize()
    culling = {}
    launches = _launched(culling)
    n_rays = cfg.width * cfg.height * cfg.spp
    hit = stats.hit.tolist()
    print(f"pallas headline frame: {time.perf_counter() - t0:.3f} s, "
          f"launches {launches} (expected {n_casts} each of B5, B6), hit "
          f"per depth {hit}, shadowed {stats.shadowed.tolist()}, image "
          f"mean {float(img.mean()):.3f}")
    if not bool(torch.isfinite(img).all()):
        _fail("pallas headline image has non-finite values")
    if not torch.equal(img, cap_img):
        _fail("pallas: the same seed gave another frame than the capture")
    if any(h != n_rays for h in hit):
        _fail(f"pallas: rays escaped the enclosed scene: hit {hit}")
    if int(stats.shadowed.sum()) <= 0:
        _fail("pallas: no shadow ray was occluded")
    expected = _none()
    expected.update(pallas_closest=n_casts, pallas_shadow=n_casts)
    if launches != expected or culling["tile_lists"] != 2 * n_casts:
        _fail(f"pallas launches in the frame {launches}, of the culling "
              f"{culling}, expected {expected} and tile_lists "
              f"{2 * n_casts}")
    launches["tile_lists"] = culling["tile_lists"]
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_frame(tables, cfg, cam, PRNGKey(i + 1, device))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    mrays = rays_per_frame(cfg) / min(times) / 1e6
    print(f"pallas headline: {mrays:.3f} Mray/s (array_bvh {cfg.width}x"
          f"{cfg.height} spp{cfg.spp} d{cfg.max_depth} pallas, frame times "
          f"{[round(t, 4) for t in times]} s) beside "
          f"the pairs headline {pairs_mrays:.3f} Mray/s of this call, on "
          f"{card}")

    # c. B5 against B0 and the dense oracle on the depth-0 rays, uncapped
    rfT = kept["pallas_closest"][0][0]
    u = Vec3(*(rfT[i].clone() for i in (0, 1, 2)))   # rows: u, O x u, O
    O = Vec3(*(rfT[i].clone() for i in (6, 7, 8)))
    b5 = pat.intersect_tris_pallas(O, u, tab, cfg.eps_leaf, sort_rays=False,
                                   subg=cfg.pallas_subgroup)
    b0 = pt.intersect_tris_pairs(O, u, tables.pairs_mesh, cfg.eps_leaf,
                                 subg=cfg.pairs_subgroup,
                                 blk=cfg.pairs_block, payload=None)
    torch.cuda.synchronize()
    if not (torch.equal(b5.t, b0.t) and torch.equal(b5.idx, b0.idx)):
        n = int(((b5.t != b0.t) | (b5.idx != b0.idx)).sum())
        _fail(f"B5 and B0 differ on {n} uncapped depth-0 rays")
    dense = [intersect_tris_dense(
        Vec3(*(c[lo:lo + cfg.ray_chunk] for c in O)),
        Vec3(*(c[lo:lo + cfg.ray_chunk] for c in u)), tables.mesh,
        cfg.eps_leaf, cfg.tri_block) for lo in range(0, O.x.shape[0],
                                                     cfg.ray_chunk)]
    t_d = torch.cat([d.t for d in dense])
    i_d = torch.cat([d.idx for d in dense])
    hit5, hitd = b5.t < pat.INF32, t_d < pat.INF32
    both = hit5 & hitd
    rel = float(((b5.t - t_d).abs() / t_d.abs())[both].max()) \
        if bool(both.any()) else 0.0
    same_idx = float((b5.idx == i_d)[both].float().mean())
    print(f"B5 vs B0 on {O.x.shape[0]} uncapped depth-0 rays: (t, idx) "
          f"bitwise equal, {int(hit5.sum())} mesh hits; dense oracle: "
          f"hit/miss {'identical' if torch.equal(hit5, hitd) else 'DIFFER'}"
          f", t max rel diff {rel:.3g}, idx equal on {same_idx:.6f} of hits")
    if not torch.equal(hit5, hitd) or rel > 1e-5 or same_idx < 0.999:
        _fail("B5 disagrees with the dense oracle")

    # d. both anchors through the pallas traversal
    acfg = dataclasses.replace(cfg, spp=8, max_depth=3)
    aimg, _ = render_frame(tables, acfg, cam, PRNGKey(0, device))
    mean = float(aimg.double().mean())
    rel = (mean - ANCHOR_CPU_MEAN) / ANCHOR_CPU_MEAN
    print(f"pallas anchor: 512x512 spp8 d3 seed 0 mean {mean:.3f} vs the JAX "
          f"package on CPU {ANCHOR_CPU_MEAN:.3f} (rel {rel:+.6f}, limit "
          f"{ANCHOR_RTOL})")
    if not abs(rel) <= ANCHOR_RTOL:
        _fail(f"pallas anchor mean {mean} off by {rel:.4%}")
    rcfg, rtab = build_preset("realtime", device, traversal="pallas")
    angle1 = np.float32(np.float32(np.arctan2(float(rtab.L.z),
                                              float(rtab.L.x)))
                        + np.float32(0.02))
    W, H, spp = rcfg.width, rcfg.height, rcfg.spp
    acc, rstats = render_rows(rt.orbit_light(rtab, angle1), rcfg,
                              Camera.default(rcfg, device),
                              fold_in(PRNGKey(0, device), 0),
                              np.arange(H, dtype=np.int32), range(spp))
    rimg = torch.stack([(c / float(spp)).reshape(H, W) for c in acc], dim=-1)
    mean = float(rimg.double().mean())
    rel = (mean - ANCHOR_RT_CPU_MEAN) / ANCHOR_RT_CPU_MEAN
    print(f"pallas realtime anchor: frame 1 (smooth normals {rcfg.smooth_normals}) "
          f"mean {mean:.3f} vs the JAX package on CPU "
          f"{ANCHOR_RT_CPU_MEAN:.3f} (rel {rel:+.6f}, limit {ANCHOR_RTOL}); "
          f"hit per depth {rstats.hit.tolist()}")
    if not rcfg.smooth_normals:
        _fail("the realtime preset lost its smooth normals")
    if any(h != W * H * spp for h in rstats.hit.tolist()):
        _fail("pallas: rays escaped the realtime scene")
    if not abs(rel) <= ANCHOR_RTOL:
        _fail(f"pallas realtime anchor mean {mean} off by {rel:.4%}")

    # e. timings on the depth-1 casts
    print("pallas kernel timings: B5 redesigned (merge walk, staged pieces), "
          "B6 the control")
    _time_casts(casts, timing, card, depths=(1,))
    return launches, aimg


def _big_mesh(device, card, err):
    """Phase 10 (module docstring).  Returns (the soup frame's launch
    counts, the B4 entry's (ms, plain_ms, bound_ms, bound_by), the soup's
    (config, scene tables))."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch import Renderer
    from raytracinggpu_tpu_torch.bench.big_mesh import soup_obj
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat
    from raytracinggpu_tpu_torch.ops.triangle import intersect_tris_dense
    from raytracinggpu_tpu_torch.render.pipeline import (
        chunk_size, group_size, rays_per_frame, render_preset_frame)

    # a. the host build through the public entry point
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "soup.obj")
        t0 = time.perf_counter()
        soup_obj(path, BIG_TRIS)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = Renderer("array_bvh", obj_path=path, bvh_builder="lbvh",
                     device=device, **BIG_FRAME)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    cfg, tables = r.cfg, r.scene
    tab = tables.pairs_mesh
    if tab is None:
        _fail("the soup fell back off the pairs tables")
    nc, Tc = tab.tile_aabb.shape[0], tab.fields.shape[1]
    print(f"soup: {BIG_TRIS} triangles written in {write_s:.2f} s, Renderer "
          f"(lbvh) built in {build_s:.2f} s: {nc} pairs tiles, "
          f"{tab.member_aabb.shape[0]} member boxes, fields "
          f"{tuple(tab.fields.shape)} ({tab.fields.numel() * 4} bytes), W = "
          f"{-(-nc // 32)} words, subgroup {cfg.pairs_subgroup}; "
          f"{tables.pallas_mesh.n_tiles} tiled-traversal tiles")
    if Tc <= ST_SLOTS:
        _fail(f"the soup's fields hold {Tc} slots, not past {ST_SLOTS}")
    W_, H_, spp = cfg.width, cfg.height, cfg.spp
    g = group_size(cfg, spp)
    R_group = g * W_ * H_
    n_casts = (spp // g) * cfg.max_depth * -(-R_group // chunk_size(cfg,
                                                                   R_group))
    if n_casts != BIG_CASTS:
        _fail(f"the soup frame makes {n_casts} casts a kernel, expected "
              f"{BIG_CASTS}")

    # b. per cast, on the busiest window of each kept cast; B3 on a copy of
    # the fields with seeded unit vertex normals (the soup has none)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    kept, (cap_img, _) = _capture_casts(
        lambda: render_preset_frame(tables, _ladder_off(cfg), seed=0), 2)
    print(f"soup capture frame (the ladder off): "
          f"{time.perf_counter() - t0:.3f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated(device) / 2**30:.3f}"
          f" GiB")
    nrm = np.random.default_rng(0).standard_normal((3, Tc, 3))
    nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
    fields3 = tab.fields.clone()
    fields3[17:26] = torch.from_numpy(
        nrm.transpose(0, 2, 1).reshape(9, Tc).astype(np.float32)).to(device)
    if not torch.equal(fields3[:17], tab.fields[:17]):
        _fail("the normals copy changed the rows B0-B2 read")
    casts = _check_casts(
        kept, {"pairs_closest": ("pairs_closest_idx", "pairs_closest_smooth"),
               "pairs_shadow": ()},
        tab, cfg, err, "soup", fields=fields3, window=WINDOW_RAYS)
    print(f"soup: B0-B3 held on windows of {WINDOW_RAYS} rays of each kept "
          f"cast of {kept['pairs_closest'][0][0].shape[1]} rays")

    # c. the frame, counted
    _kernels.reset_launches()
    t0 = time.perf_counter()
    img, stats = r.render_hdr(seed=0)
    counted_s = time.perf_counter() - t0
    launches = _launched()
    n_rays = W_ * H_ * spp
    print(f"soup frame: {counted_s:.3f} s, launches {launches}, hit per depth "
          f"{stats.hit.tolist()}, shadowed {stats.shadowed.tolist()}, image "
          f"mean {float(img.mean()):.3f}")
    if not np.isfinite(img).all():
        _fail("the soup frame has non-finite values")
    if not np.array_equal(img, cap_img):
        _fail("the soup: the same seed gave another frame (the ladder on) "
              "than the capture (the ladder off)")
    if any(h != n_rays for h in stats.hit.tolist()):
        _fail(f"the soup: rays escaped the enclosed scene: {stats.hit}")
    expected = _none()
    expected.update(pairs_closest=n_casts, pairs_shadow=n_casts)
    if launches != expected:
        _fail(f"soup frame launches {launches}, expected {expected}")

    def timed_frames(render):
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            render(i + 1)   # returns host numpy: synchronous
            times.append(time.perf_counter() - t0)
        return times

    times_auto = timed_frames(lambda seed: r.render_hdr(seed=seed))
    print(f"soup headline: {rays_per_frame(cfg) / min(times_auto) / 1e6:.3f} "
          f"Mray/s ({rays_per_frame(cfg)} rays a frame, {min(times_auto):.4f} s "
          f"a frame, frame times {[round(t, 4) for t in times_auto]} s, "
          f"subgroup {cfg.pairs_subgroup}) on {card}")

    # d. subgroup 64: exact culling, so the same frame; its depth-1 casts
    cfg64 = dataclasses.replace(cfg, pairs_subgroup=64)
    kept64, (img64, stats64) = _capture_casts(
        lambda: render_preset_frame(tables, _ladder_off(cfg64), seed=0), 2)
    if not (np.array_equal(img64, img) and all(
            np.array_equal(a, b) for a, b in zip(stats64, stats))):
        _fail(f"the soup frame at subgroup 64 differs from subgroup "
              f"{cfg.pairs_subgroup}'s")
    times64 = timed_frames(lambda seed: render_preset_frame(tables, cfg64,
                                                            seed=seed))
    print(f"soup frame at subgroup 64: bitwise the subgroup-"
          f"{cfg.pairs_subgroup} frame; "
          f"{rays_per_frame(cfg) / min(times64) / 1e6:.3f} Mray/s "
          f"({min(times64):.4f} s a frame) beside subgroup "
          f"{cfg.pairs_subgroup}'s "
          f"{rays_per_frame(cfg) / min(times_auto) / 1e6:.3f} on {card}")
    for k in ("pairs_closest", "pairs_shadow"):
        for subg, cast in ((cfg.pairs_subgroup, kept[k][1]),
                           (64, kept64[k][1])):
            args = (cast[0], tab.fields, cast[1], cfg.eps_leaf, subg, 128)
            ms = _time_ms(lambda: getattr(_kernels, k)(*args), 10)
            visits, tests = _mt_tests(k, args)
            print(f"timing {k} on the soup depth-1 cast at subgroup {subg}: "
                  f"{ms:.4f} ms, {visits} (subgroup, tile) visits, {tests} "
                  f"MT tests, {ms * 1e9 / tests:.3f} ps a test, on {card}")

    # e. the tiled fallback on the same soup
    cfgp = dataclasses.replace(cfg, traversal="pallas")
    _kernels.reset_launches()
    imgp, statsp = render_preset_frame(tables, cfgp, seed=0)
    launches_p = _launched()
    expected = _none()
    expected.update(pallas_closest=n_casts, pallas_shadow=n_casts)
    diff = float(np.abs(imgp.astype(np.float64) - img).max())
    print(f"soup pallas frame: launches {launches_p}, hit per depth "
          f"{statsp.hit.tolist()}, shadowed {statsp.shadowed.tolist()}; "
          f"largest difference from the pairs frame {diff} "
          f"({'bitwise equal' if np.array_equal(imgp, img) else 'not bitwise'})")
    if launches_p != expected:
        _fail(f"soup pallas launches {launches_p}, expected {expected}")
    if not (np.array_equal(statsp.hit, stats.hit)
            and np.array_equal(statsp.shadowed, stats.shadowed)):
        _fail("the soup's pallas frame hit or shadowed other rays")
    timesp = timed_frames(lambda seed: render_preset_frame(tables, cfgp,
                                                           seed=seed))
    print(f"soup pallas: {rays_per_frame(cfg) / min(timesp) / 1e6:.3f} Mray/s "
          f"({min(timesp):.4f} s a frame) beside pairs "
          f"{rays_per_frame(cfg) / min(times_auto) / 1e6:.3f} on {card}")

    # f. the dense oracle on kept depth-0 rays, uncapped
    rfT, _, a = _window(*kept["pairs_closest"][0], cfg.pairs_subgroup,
                        ORACLE_RAYS)
    u = Vec3(*(rfT[i].clone() for i in (0, 1, 2)))   # rows: u, O x u, O
    O = Vec3(*(rfT[i].clone() for i in (6, 7, 8)))
    b1, _ = pt.intersect_tris_pairs(O, u, tab, cfg.eps_leaf,
                                    subg=cfg.pairs_subgroup,
                                    blk=cfg.pairs_block, payload="geom")
    dense = intersect_tris_dense(O, u, tables.mesh, cfg.eps_leaf,
                                 cfg.tri_block)
    hit1, hitd = b1.t < pt.INF32, dense.t < pt.INF32
    both = hit1 & hitd
    rel = (float(((b1.t - dense.t).abs() / dense.t.abs())[both].max())
           if bool(both.any()) else 0.0)
    same_idx = float((b1.idx == dense.idx)[both].float().mean())
    # The oracle sums its Moller-Trumbore terms in a matrix product, the
    # kernels left to right, so a ray that grazes a triangle's edge can
    # hit by one and miss by the other; in a soup no neighbour takes the
    # hit.  A flip passes only where the kernels' own arithmetic, with no
    # culling, puts the deciding triangle within EDGE_MARGIN of its edge
    # and agrees with B1 (a hit B1 lost to the culling fails).
    flips = (hit1 != hitd).nonzero().flatten().tolist()
    margins = []
    for i in flips:
        tid = int((b1.idx if hit1[i] else dense.idx)[i])
        slot = int((tab.fields[16] == tid).nonzero()[0])
        rf = pat.ray_rows_plain(Vec3(*(c[i:i + 1] for c in O)),
                                Vec3(*(c[i:i + 1] for c in u)))
        _, beta, gamma, ok = pat.mt_slots(rf, tab.fields[:, slot:slot + 1],
                                          cfg.eps_leaf, 0, 1)
        m = float(torch.minimum(torch.minimum(beta, gamma),
                                1.0 - beta - gamma))
        margins.append(m)
        if bool(ok) != bool(hit1[i]) or abs(m) > EDGE_MARGIN:
            _fail(f"soup oracle: ray {a + i} hit/miss differs (B1 "
                  f"{bool(hit1[i])}, kernel arithmetic {bool(ok)}) on "
                  f"triangle {tid}, {m} from its edge")
    print(f"soup oracle: {ORACLE_RAYS} depth-0 rays from ray {a}, uncapped: "
          f"{int(hit1.sum())} mesh hits; hit/miss identical on "
          f"{ORACLE_RAYS - len(flips)} rays, {len(flips)} edge grazes differ "
          f"(barycentric margins {margins}, limit {EDGE_MARGIN}); t max rel "
          f"diff {rel:.3g}, idx equal on {same_idx:.6f} of hits")
    if len(flips) > ORACLE_RAYS // 1000 or rel > 1e-5 or same_idx < 0.999:
        _fail("B1 disagrees with the dense oracle on the soup")

    # g. B1 and B2 on the depth-1 casts: the kernel and its bound on the
    # whole cast, as the frame runs it; the kernel, its plain version and
    # the bound on the busiest window that 10b held bitwise (a plain
    # version tests every slot of 16 rays at a time: tens of seconds for a
    # whole cast).  The B4 entry sums the window's numbers.
    total, bound_bys = [0.0, 0.0, 0.0], set()
    for k in ("pairs_closest", "pairs_shadow"):
        kern, plain = getattr(_kernels, k), getattr(pt, f"{k}_plain")
        rfT, bits = kept[k][1]
        whole = (rfT, tab.fields, bits, cfg.eps_leaf, cfg.pairs_subgroup, 128)
        window = next(a for _, d, ks, a in casts if d == 1 and ks[0] == k)
        for where, args in (("whole cast", whole), ("window", window)):
            ms = _time_ms(lambda: kern(*args), 10)
            out = kern(*args)
            bound_ms, bound_by = _bound(k, args, out if isinstance(out, tuple)
                                        else (out,))
            visits, tests = _mt_tests(k, args)
            line = (f"timing {k} on the soup depth-1 {where} "
                    f"({args[0].shape[1]} rays, {visits} (subgroup, tile) "
                    f"visits, {tests} MT tests): kernel {ms:.4f} ms")
            if where == "window":
                plain_ms = _time_ms(lambda: plain(*args), 1)
                for i, v in enumerate((ms, plain_ms, bound_ms)):
                    total[i] += v
                bound_bys.add(bound_by)
                line += f", plain {plain_ms:.4f} ms"
            print(f"{line}, bound {bound_ms:.4f} ms ({bound_by}; roofline "
                  f"share {bound_ms / ms:.1%}) on {card}")
    print(f"B4 (B1 + B2 on the busiest {WINDOW_RAYS}-ray windows of the "
          f"soup's depth-1 casts): {total[0]:.4f} ms, plain versions "
          f"{total[1]:.4f} ms, bound {total[2]:.4f} ms")
    return launches, (*total, "operations" if bound_bys == {"operations"}
                      else "bytes"), (cfg, tables)


def _probe_bound(tests: int, nbytes: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of a probe: its MT tests' operations over the
    f32 peak, or the bytes it must move over the memory rate, the larger."""
    ops_s = tests * FLOP_PER_TEST / PEAK_F32_FLOPS
    bytes_s = nbytes / PEAK_BYTES_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _probes(device, card, err):
    """Phase 11 (module docstring).  Returns (the entry point's launch
    counts, {probe: (ms, plain_ms, bound_ms, bound_by)}, {probe: the ms of
    the one PyTorch call that computes it})."""
    import torch
    from raytracinggpu_tpu_torch.bench import micro_kernel as mk
    from raytracinggpu_tpu_torch.bench._timing import timed
    from raytracinggpu_tpu_torch.ops import _kernels

    # a. every configuration bitwise, at both sizes
    for R, n_tiles in (PROBE_DEFAULT, PROBE_CAST):
        t0 = time.perf_counter()
        n = 0
        for c in mk.cases(R, n_tiles, device):
            name, label = c["kernel"], c["label"]
            got = c["run"](*c["args"])
            torch.cuda.synchronize()
            want = c["plain"](*c["args"])
            e = _max_abs_err(got, want)
            err[name] = max(err[name], e)
            if not (got.is_cuda and torch.equal(got, want)):
                _fail(f"{name} ({label}) differs from its plain version at "
                      f"{R} rays, {n_tiles} tiles (max abs {e})")
            if c["probe"] in ("slope", "pairslope") \
                    and bool((got < mk.MISS).any()) != (c["L"] > 0):
                _fail(f"{name} ({label}): hits with no visit, or none with "
                      "some")
            n += 1
        print(f"probes at {R} rays, {n_tiles} tiles: {n} configurations of "
              f"{len(_kernels.PROBES)} kernels bitwise equal to their plain "
              f"versions ({time.perf_counter() - t0:.2f} s)")

    # b. the entry point, counted, then its tables at the cast size
    R, n_tiles = PROBE_DEFAULT
    _kernels.reset_launches()
    res = mk.main([])
    torch.cuda.synchronize()
    launches = _launched()
    print(f"probe entry point: launches {launches} on {card}")
    for k, n in launches.items():
        if (n > 0) != (k in _kernels.PROBES):
            _fail(f"the probe entry point launched {k} {n} times")
    iters = 30
    print(f"the same tables at {PROBE_CAST[0]} rays, {PROBE_CAST[1]} tiles, "
          f"on {card}:")
    mk.bench_pair_slope(*PROBE_CAST, iters, device)
    mk.bench_tile_slope(*PROBE_CAST, iters, device)
    cast_rows = {"probe_block_mask": mk.bench_dma_smem(PROBE_CAST[0], iters,
                                                       device)}
    mk.bench_scalar_branch(*PROBE_CAST, iters, device)
    cast_rows["probe_row_gather"] = mk.bench_inkernel_gather(PROBE_CAST[0],
                                                             iters, device)

    timing, rows = {}, {}
    for name, (key, want) in _PROBE_ROW.items():
        case = rows[name] = res[key] if want is None else next(
            c for c in res[key] if all(c[k] == v for k, v in want.items()))
        bound_ms, bound_by = _probe_bound(case["tests"], case["nbytes"])
        timing[name] = (case["s"] * 1e3, case["plain_s"] * 1e3, bound_ms,
                        bound_by)
        print(f"timing {name} ({want or ''}; {R} rays, {n_tiles} tiles, "
              f"{case['tests']} MT tests, {case['nbytes']} bytes): "
              f"kernel {timing[name][0]:.4f} ms, plain {timing[name][1]:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}; roofline share "
              f"{bound_ms / timing[name][0]:.1%}) on {card}")
    # the one PyTorch call that computes B7b (2 x) and B7d (a row gather),
    # on the inputs the kernels were timed on at both sizes, replayed from
    # a graph as the kernels are (the JSON line keeps PROBE_DEFAULT's)
    library = {}
    for size, cases in ((PROBE_DEFAULT[0], rows), (PROBE_CAST[0], cast_rows)):
        x = cases["probe_block_mask"]["args"][0]
        idx, table = cases["probe_row_gather"]["args"]
        idx = idx[:, 0]
        for name, what, call in (
                ("probe_block_mask", "torch.mul", lambda: torch.mul(x, 2.0)),
                ("probe_row_gather", "torch.index_select",
                 lambda: torch.index_select(table, 0, idx))):
            case = cases[name]
            if not torch.equal(call(), case["out"]):
                _fail(f"{what} differs from the {name} kernel at {size} rows")
            n = min(300, max(30, math.ceil(2e-3 / case["s"])))
            ms = timed(call, n, graph=True) * 1e3
            if size == PROBE_DEFAULT[0]:
                library[name] = ms
            kernel = f"the kernel's {case['s'] * 1e6:.3f} us"
            if "control_s" in case:
                kernel += f" and its control's {case['control_s'] * 1e6:.3f}"
            print(f"timing {what} on {name}'s inputs at {size} rows: "
                  f"{ms * 1e3:.3f} us beside {kernel} "
                  f"({case['s'] * 1e3 / ms:.3f} of the library's time), on "
                  f"{card}")
    return launches, timing, library


def _sweep_and_presets(device, card, headline_mrays):
    """Phase 12 (module docstring)."""
    import torch
    from raytracinggpu_tpu_torch.bench.sweep import run_sweep
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, chunk_size, group_size, rays_per_frame, render_frame)
    from raytracinggpu_tpu_torch.scene.presets import (
        build_preset, make_config)

    def casts(cfg):
        g = group_size(cfg, cfg.spp)
        R_group = g * cfg.width * cfg.height
        return (cfg.spp // g) * cfg.max_depth * -(-R_group
                                                  // chunk_size(cfg, R_group))

    # a. the sweep through the public function
    spps, bounces, repeats = (8, 32), (3, 5), 3
    _kernels.reset_launches()
    res = run_sweep(preset="array_bvh", width=512, height=512, spps=spps,
                    bounces=bounces, repeats=repeats, traversal="pairs",
                    device=device)
    launches = _launched()
    frames = 1 + max(1, repeats - 1)
    n_casts = frames * sum(
        casts(make_config("array_bvh", width=512, height=512, spp=s,
                          max_depth=b)) for s in spps for b in bounces)
    expected = _none()
    expected.update(pairs_closest=n_casts, pairs_shadow=n_casts)
    print(f"sweep: launches {launches} (expected {n_casts} each of B1, B2)")
    if launches != expected:
        _fail(f"sweep launches {launches}, expected {expected}")
    if sorted(res) != sorted((s, b) for s in spps for b in bounces):
        _fail(f"sweep cells {sorted(res)}")
    for cell, r in res.items():
        if not all(math.isfinite(r[k]) and r[k] > 0
                   for k in ("first_s", "steady_s", "mrays")):
            _fail(f"sweep cell {cell}: {r}")
    print(f"sweep cell spp 32 x depth 5: {res[(32, 5)]['mrays']:.3f} Mray/s "
          f"(the mean of {frames - 1} frames) beside the headline "
          f"{headline_mrays:.3f} Mray/s (the best of 3) of this call, on "
          f"{card}")

    # b. one frame of each of the other presets
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           CPU_PRESET_HITS_FILE)) as f:
        cpu_hits = tuple(json.load(f)["hits_per_depth"])
    for preset in ("cpu", "global", "optimized", "showcase"):
        t0 = time.perf_counter()
        cfg, tables = build_preset(preset, device, width=512, height=512,
                                   spp=8, max_depth=5)
        cam = Camera.default(cfg, device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _kernels.reset_launches()
        img, stats = render_frame(tables, cfg, cam, PRNGKey(0, device))
        torch.cuda.synchronize()
        launches = _launched()
        n = 0 if tables.mesh is None else casts(cfg)
        expected = _none()
        expected.update(pairs_closest=n, pairs_shadow=n)
        n_rays = cfg.width * cfg.height * cfg.spp
        if not bool(torch.isfinite(img).all()):
            _fail(f"{preset}: the frame has non-finite values")
        hit = stats.hit.tolist()
        want_hit = cpu_hits if preset == "cpu" else (n_rays,) * 5
        slack = HIT_RTOL * n_rays if preset == "cpu" else 0
        if any(abs(h - w) > slack for h, w in zip(hit, want_hit)) \
                or hit[:2] != [n_rays] * 2:
            _fail(f"{preset}: hits per depth {hit}, expected {want_hit}")
        if launches != expected:
            _fail(f"{preset}: launches {launches}, expected {expected}")
        times = []
        for i in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_frame(tables, cfg, cam, PRNGKey(i, device))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        same = (" (the JAX package on CPU: the same)"
                if preset == "cpu" and tuple(hit) == cpu_hits else "")
        print(f"preset {preset}: built in {build_s:.2f} s, {cfg.width}x"
              f"{cfg.height} spp{cfg.spp} d{cfg.max_depth} frame mean "
              f"{float(img.mean()):.3f}, hits per depth {hit} of {n_rays}"
              f"{same}, "
              f"{n} launches each of B1, B2, shadowed "
              f"{stats.shadowed.tolist()}; "
              f"{rays_per_frame(cfg) / min(times) / 1e6:.3f} Mray/s (frame "
              f"times {[round(t, 4) for t in times]} s) on {card}")
        if preset == "showcase":
            mirror, refract, tir = (int(x.sum()) for x in (
                stats.mirror, stats.refract, stats.tir))
            print(f"preset showcase: lanes per depth through the mirror "
                  f"branch {stats.mirror.tolist()}, refraction "
                  f"{stats.refract.tolist()}, total internal reflection "
                  f"{stats.tir.tolist()}")
            if mirror <= 0 or refract <= 0:
                _fail(f"showcase: mirror {mirror}, refraction {refract} "
                      "lanes")
        elif int(stats.shadowed.sum()) <= 0:
            _fail(f"{preset}: no shadow ray was occluded")


def _pixels_within_one_level(a, b) -> float:
    """Share of pixels whose tonemapped u8 colours differ by at most one
    level in every channel."""
    from raytracinggpu_tpu_torch.render.image_io import tonemap

    d = abs(tonemap(a).astype(int) - tonemap(b).astype(int))
    return float((d.max(axis=-1) <= 1).mean())


def _animated_loop(device, card, err, unanimated_ms):
    """Phase 13a (module docstring).  Returns (the loop's launch counts,
    its ms a frame)."""
    import io

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.scene.presets import build_preset
    from raytracinggpu_tpu_torch.scene.transform import pose_mesh, rotation_y
    from raytracinggpu_tpu_torch.utils.profiling import device_kernels, wall_ms

    cfg, tables = build_preset("realtime", device, animate_mesh=True)
    W, H = cfg.width, cfg.height
    if (W, H, cfg.spp, cfg.max_depth) != (512, 512, 20, 3) \
            or not cfg.animate_mesh:
        _fail("the animated realtime scene is not 512x512 spp 20 depth 3")
    per_frame = 30
    want = _none()
    want.update(pairs_closest_smooth=per_frame * LOOP_FRAMES,
                pairs_shadow=per_frame * LOOP_FRAMES)
    pipe = io.BytesIO()
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    state, _ = rt.run_loop(tables, cfg, LOOP_FRAMES, seed=0, raw_pipe=pipe,
                           print_every=0)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / LOOP_FRAMES * 1e3
    launches = _launched()
    angle = np.float32(0.0)
    for _ in range(LOOP_FRAMES):   # angle + mesh_speed * dt, one rounding
        angle = np.float32(np.float64(angle) + np.float64(np.float32(1.0))
                           * np.float64(np.float32(0.02)))
    print(f"animated loop: {LOOP_FRAMES} frames, {frame_ms:.3f} ms per frame "
          f"beside the unanimated loop's {unanimated_ms:.3f} (phase 7c, this "
          f"call), launches {launches}, mesh angle "
          f"{float(state.mesh_angle)!r}, on {card}")
    if launches != want:
        _fail(f"animated loop launches {launches}, expected {want}")
    if (float(state.mesh_angle), int(state.frames)) != (float(angle),
                                                        LOOP_FRAMES):
        _fail(f"animated loop mesh angle {float(state.mesh_angle)!r}, "
              f"expected {float(angle)!r}")
    if not bool(torch.isfinite(state.accum).all()):
        _fail("the animated loop's image has non-finite values")

    # frame 2 from two steps, its casts kept: the loop's second display,
    # and the kernels on the posed fields
    s1, _ = rt.step(tables, cfg, rt.init_state(cfg, tables, seed=0))
    kept, (s2, disp2) = _capture_casts(lambda: rt.step(tables, cfg, s1), 2)
    shown = np.frombuffer(pipe.getvalue(), np.uint8).reshape(
        LOOP_FRAMES, H, W, 3)
    if not np.array_equal(shown[1], disp2.cpu().numpy()):
        _fail("the animated loop's frame 2 differs from two steps'")
    posed = pose_mesh(tables, rotation_y(s2.mesh_angle))
    if torch.equal(posed.pairs_mesh.fields, tables.pairs_mesh.fields):
        _fail("frame 2's pose left the pairs fields unchanged")
    _check_casts(kept, {"pairs_closest_smooth": ("pairs_closest_idx",),
                        "pairs_shadow": ()},
                 posed.pairs_mesh, cfg, err, "animated frame 2")
    pose = lambda: pose_mesh(tables, rotation_y(s2.mesh_angle))
    pose_ms = _time_ms(pose, 20)
    prof = device_kernels(pose)
    wall = wall_ms(pose, device)
    print(f"pose_mesh: {pose_ms:.4f} ms a frame between CUDA events "
          f"({tables.mesh.n_tri} triangles, every table rebuilt); one pose "
          f"{wall:.3f} ms on the host clock, {prof['kernels']} kernels "
          f"{prof['kernel_ms']:.4f} ms of device time (busy "
          f"{prof['kernel_ms'] / wall:.3f}), on {card}")
    return launches, frame_ms


def _animated_anchor(device):
    """Phase 13b (module docstring)."""
    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    for traversal in ("pairs", "pallas"):
        cfg, tables = build_preset("realtime", device, animate_mesh=True,
                                   traversal=traversal)
        state, _ = rt.step(tables, cfg, rt.init_state(cfg, tables, seed=0),
                           mesh_speed=ANIM_MESH_SPEED)
        mean = float(state.accum.double().mean())
        rel = (mean - ANCHOR_ANIM_CPU_MEAN) / ANCHOR_ANIM_CPU_MEAN
        print(f"animated anchor ({traversal}): frame 1 at mesh angle "
              f"{float(state.mesh_angle)!r} mean {mean:.3f} vs the JAX "
              f"package on CPU {ANCHOR_ANIM_CPU_MEAN:.3f} (rel {rel:+.6f}, "
              f"limit {ANCHOR_RTOL})")
        if float(state.mesh_angle) != float(np.float32(0.9)):
            _fail(f"frame 1's mesh angle {float(state.mesh_angle)!r}")
        if not bool(torch.isfinite(state.accum).all()):
            _fail(f"animated anchor ({traversal}): non-finite values")
        if not abs(rel) <= ANCHOR_RTOL:
            _fail(f"animated anchor ({traversal}) mean {mean} off by "
                  f"{rel:.4%}")


def _posed_vs_host(device):
    """Phase 13c (module docstring)."""
    import torch
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame
    from raytracinggpu_tpu_torch.scene.mesh import (
        build_mesh, rescale, rotate_y)
    from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH, read_obj
    from raytracinggpu_tpu_torch.scene.presets import build_preset
    from raytracinggpu_tpu_torch.scene.transform import pose_mesh, rotation_y

    size = dict(width=512, height=512, spp=8, max_depth=3)
    obj = read_obj(CAT_OBJ_PATH)
    obj.vertices = rotate_y(rescale(obj.vertices, 0.6, (0.0, -10.0, 0.0)),
                            POSE_ANGLE)
    host_mesh = build_mesh(obj)
    for traversal in ("pairs", "pallas"):
        cfg, tables = build_preset("array_bvh", device, traversal=traversal,
                                   **size)
        posed = pose_mesh(tables, rotation_y(POSE_ANGLE, device))
        cam = Camera.default(cfg, device)
        img, _ = render_frame(posed, cfg, cam, PRNGKey(0, device))
        _, host = build_preset("array_bvh", device, mesh=host_mesh,
                               traversal=traversal, **size)
        ref, _ = render_frame(host, cfg, cam, PRNGKey(0, device))
        share = _pixels_within_one_level(img.cpu().numpy(),
                                         ref.cpu().numpy())
        print(f"posed vs host rebuild ({traversal}, 512x512 spp8 d3, "
              f"{POSE_ANGLE} rad): {share:.6f} of pixels within one u8 level "
              f"(limit {POSE_PIXEL_SHARE})")
        if share < POSE_PIXEL_SHARE:
            _fail(f"posed {traversal} frame off the host rebuild on "
                  f"{1 - share:.4%} of pixels")
    # an identity pose reproduces the host-built tables bit for bit
    ident = pose_mesh(tables, rotation_y(0.0, device))
    pairs = [(getattr(ident.pairs_mesh, f), getattr(tables.pairs_mesh, f))
             for f in ("fields", "tile_aabb", "member_aabb")]
    tiled = [(getattr(ident.pallas_mesh, f), getattr(tables.pallas_mesh, f))
             for f in ("fields", "fieldsT", "tile_aabb")]
    tri = [(ident.mesh.mt, tables.mesh.mt),
           (ident.mesh.cornersT, tables.mesh.cornersT)]
    boxes = list(zip((*ident.bvh.mn, *ident.bvh.mx),
                     (*tables.bvh.mn, *tables.bvh.mx)))
    if not all(torch.equal(a, b) for a, b in pairs + tiled + tri + boxes):
        _fail("an identity pose changed a host-built table on the card")
    print("identity pose: the pairs, tiled and triangle tables and the BVH "
          "boxes bitwise the host build's")
    # every posed vertex inside its tile box and its member box
    src = tables.mesh_src
    pm, tm = posed.pairs_mesh, posed.pallas_mesh
    live = pm.slot_src >= 0
    slot = pm.slot_src[live].long()
    tile_t = pm.slot_src.shape[0] // pm.tile_aabb.shape[0]
    tile = live.nonzero()[:, 0] // tile_t
    member = pm.member_slot[live].long()
    valid = src.valid.nonzero()[:, 0]
    M = rotation_y(POSE_ANGLE, device)
    worst = 0.0
    for corner in (src.A, src.B, src.C):
        V = torch.stack(list(corner), dim=1) @ M.T
        for boxes, rows, pts in ((pm.tile_aabb, tile, V[slot]),
                                 (pm.member_aabb, member, V[slot]),
                                 (tm.tile_aabb, valid // 128, V[valid])):
            out = torch.maximum(boxes[rows, 0:3] - pts,
                                pts - boxes[rows, 3:6]).max()
            worst = max(worst, float(out))
    print(f"posed tables: every vertex inside its pairs tile box, member box "
          f"and tiled tile box (largest excess {worst:.3g}, limit 1e-3)")
    if worst > 1e-3:
        _fail(f"a posed vertex lies {worst} outside its box")


def _bvh_walk(device, card, rfT):
    """Phase 13d (module docstring); ``rfT`` the ray features of phase 3's
    depth-0 closest cast."""
    import dataclasses

    import torch
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops.bvh_traverse import intersect_tris_bvh
    from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame
    from raytracinggpu_tpu_torch.scene.presets import build_preset
    from raytracinggpu_tpu_torch.utils.profiling import device_kernels, wall_ms

    cfg, tables = build_preset("array_bvh", device, width=512, height=512,
                               spp=8, max_depth=3, traversal="bvh")
    cam = Camera.default(cfg, device)
    n_rays = cfg.width * cfg.height * cfg.spp
    none = _none()
    imgs = {}
    for layout in ("soa", "aos10"):
        lcfg = dataclasses.replace(cfg, bvh_node_layout=layout)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        img, stats = render_frame(tables, lcfg, cam, PRNGKey(0, device))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        mean = float(img.double().mean())
        rel = (mean - ANCHOR_CPU_MEAN) / ANCHOR_CPU_MEAN
        hit = stats.hit.tolist()
        print(f"bvh ({layout}): production anchor 512x512 spp8 d3 seed 0 in "
              f"{secs:.3f} s, mean {mean:.3f} vs the JAX package on CPU "
              f"{ANCHOR_CPU_MEAN:.3f} (rel {rel:+.6f}, limit {ANCHOR_RTOL}), "
              f"hit per depth {hit}, launches {_launched()}, on "
              f"{card}")
        if _launched() != none:
            _fail(f"bvh ({layout}) launched a kernel")
        if any(h != n_rays for h in hit):
            _fail(f"bvh ({layout}): rays escaped the enclosed scene: {hit}")
        if not abs(rel) <= ANCHOR_RTOL:
            _fail(f"bvh ({layout}) anchor mean {mean} off by {rel:.4%}")
        imgs[layout] = img
    if not torch.equal(imgs["soa"], imgs["aos10"]):
        _fail("the bvh frames of the soa and aos10 layouts differ")
    print("bvh: the soa and aos10 frames are bitwise equal")

    # the walk against B0 on the headline frame's depth-0 rays, uncapped
    u = Vec3(*(rfT[i].clone() for i in (0, 1, 2)))   # rows: u, O x u, O
    O = Vec3(*(rfT[i].clone() for i in (6, 7, 8)))
    run = lambda: intersect_tris_bvh(O, u, tables.mesh, tables.bvh,
                                     cfg.eps_leaf, cfg.bvh_max_leaf)
    walk = run()
    walk_ms = wall_ms(run, device)
    prof = device_kernels(run)
    b0 = pt.intersect_tris_pairs(O, u, tables.pairs_mesh, cfg.eps_leaf,
                                 subg=cfg.pairs_subgroup, blk=cfg.pairs_block,
                                 payload=None)
    hw, h0 = walk.t < pt.INF32, b0.t < pt.INF32
    both = hw & h0
    same_hit = float((hw == h0).float().mean())
    same_idx = float((walk.idx == b0.idx)[both].float().mean())
    rel = float(((walk.t - b0.t).abs() / b0.t.abs())[both].max())
    print(f"bvh walk vs B0 on {O.x.shape[0]} uncapped depth-0 rays: hit/miss "
          f"equal on {same_hit:.6f}, {int(h0.sum())} B0 hits, idx equal on "
          f"{same_idx:.6f} of both hits, t max rel diff {rel:.3g}; the walk "
          f"{walk_ms:.1f} ms on the host clock, {prof['kernels']} kernels "
          f"{prof['kernel_ms']:.1f} ms of device time (busy "
          f"{prof['kernel_ms'] / walk_ms:.3f}), on {card}")
    if same_hit < 0.999 or same_idx < 0.999 or rel > 1e-5:
        _fail("the bvh walk disagrees with B0")


def _clustering(device, card, head_img):
    """Phase 13e (module docstring); ``head_img`` phase 4's frame."""
    import torch
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, chunk_size, group_size, render_frame)
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    for name, (tree, pack, cut) in (("ref", ("ref", "morton", 0)),
                                    *CLUSTERINGS.items()):
        t0 = time.perf_counter()
        cfg, tables = build_preset(
            "array_bvh", device, width=512, height=512, spp=32, max_depth=5,
            pairs_cluster=tree, pairs_pack=pack, pairs_cut=cut)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        tab = tables.pairs_mesh
        g = group_size(cfg, cfg.spp)
        R_group = g * cfg.width * cfg.height
        n_casts = (cfg.spp // g) * cfg.max_depth * -(
            -R_group // chunk_size(cfg, R_group))
        want = _none()
        want.update(pairs_closest=n_casts, pairs_shadow=n_casts)
        _kernels.reset_launches()
        kept, (img, _) = _capture_casts(lambda: render_frame(
            tables, _ladder_off(cfg), Camera.default(cfg, device),
            PRNGKey(0, device)), 2)
        torch.cuda.synchronize()
        launches = _launched()
        if launches != want:
            _fail(f"clustering {name}: launches {launches}, expected {want}")
        if not torch.equal(img, head_img):
            _fail(f"clustering {name} changed the headline frame")
        ms = {}
        for k in ("pairs_closest", "pairs_shadow"):
            rfT, bits = kept[k][1]   # the depth-1 cast
            args = (rfT, tab.fields, bits, cfg.eps_leaf, cfg.pairs_subgroup,
                    pt.tile_width(tab))
            kern = getattr(_kernels, k)
            ms[k] = _time_ms(lambda: kern(*args), 20)
            ms[k + " tests"] = _mt_tests(k, args)[1]
        print(f"clustering {name} (pairs_cluster {tree}, pack {pack}, cut "
              f"{cut}): {tab.tile_aabb.shape[0]} tiles, "
              f"{tab.member_aabb.shape[0]} members, host build "
              f"{build_s:.3f} s; headline frame bitwise phase 4's, B1 and B2 "
              f"{n_casts} launches each; depth-1 cast B1 "
              f"{ms['pairs_closest']:.4f} ms ({ms['pairs_closest tests']} MT "
              f"tests), B2 {ms['pairs_shadow']:.4f} ms "
              f"({ms['pairs_shadow tests']} MT tests), on {card}")


# Phase 14: (case, traversal, mesh (px, sp)); a and b the headline frame,
# c the production anchor through the tiled kernels
SHARDED_CASES = (("a", "pairs", (2, 1)), ("b", "pairs", (1, 2)),
                 ("c", "pallas", (2, 1)))
SHARDED_TIMEOUT = 300.0  # seconds the two ranks may take together


def _sharded_rank(device, out_dir):
    """Phase 14a-c, one rank: each case rendered sharded with its counters
    zeroed just before; its frame, TraceStats, launches (and those one
    cast a kernel predicts), render and exchange seconds and the bytes it
    hands to all_reduce written to ``out_dir``."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.parallel.sharding import (
        make_mesh, merge_shards, render_frame_sharded, render_shard,
        shard_shape)
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, chunk_size, group_size)
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    _kernels.load()  # phase 2's library: loaded, not built
    rank = dist.get_rank()
    meshes = {shape: make_mesh(*shape, device=device)
              for shape in {m for _, _, m in SHARDED_CASES}}
    size = dict(width=512, height=512, spp=32, max_depth=5)
    scenes = {"pairs": build_preset("array_bvh", device, **size)}
    pcfg, ptab = build_preset("array_bvh", device, traversal="pallas", **size)
    scenes["pallas"] = (dataclasses.replace(pcfg, spp=8, max_depth=3), ptab)
    # warm-up, not reported: a process's first frame also pays for its
    # allocator and first launches, a group's first exchange for its
    # buffers
    wcfg = dataclasses.replace(scenes["pairs"][0], spp=2, max_depth=1)
    for mesh in meshes.values():
        render_frame_sharded(scenes["pairs"][1], wcfg,
                             Camera.default(wcfg, device),
                             PRNGKey(1, device), mesh)
    for name, traversal, shape in SHARDED_CASES:
        cfg, tables = scenes[traversal]
        mesh = meshes[shape]
        rows, spp = shard_shape(cfg.height, cfg.spp, *shape)
        g = group_size(cfg, spp)
        R_group = g * rows * cfg.width
        n_casts = (spp // g) * cfg.max_depth * -(
            -R_group // chunk_size(cfg, R_group, traversal))
        expected = _none()
        expected.update({f"{traversal}_closest": n_casts,
                         f"{traversal}_shadow": n_casts})
        cam = Camera.default(cfg, device)
        torch.cuda.synchronize()
        dist.barrier()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        part, stats = render_shard(tables, cfg, cam, PRNGKey(0, device), mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = _launched()
        dist.barrier()  # the exchange alone, not the wait for the peer
        t2 = time.perf_counter()
        img, stats = merge_shards(cfg, mesh, part, stats)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        nbytes = (part.numel() * 4 if shape[1] > 1 else 0) + (
            img.numel() * 4 if shape[0] > 1 else 0) + 8 * sum(
            s.numel() for s in stats)
        np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"),
                 img=img.cpu().numpy(),
                 stats=torch.stack(tuple(stats)).cpu().numpy(),
                 launches=json.dumps(launches), expected=json.dumps(expected),
                 seconds=np.array([t1 - t0, t3 - t2, t3 - t0]),
                 nbytes=nbytes)


def _sharded(device, card, count, head_img, head_stats, pallas_anchor):
    """Phase 14 (module docstring); ``head_img`` and ``head_stats`` phase
    4's frame, ``pallas_anchor`` phase 9d's."""
    import tempfile

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.parallel.multihost_demo import (
        dryrun_multichip)
    from raytracinggpu_tpu_torch.parallel.sharding import launch

    torch.cuda.empty_cache()  # the ranks share the card with this process
    want = {"a": head_img, "b": head_img, "c": pallas_anchor}
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # d. the CLI in processes of its own, started beside the ranks
        cli = [sys.executable, "-m", "raytracinggpu_tpu_torch.cli", "render",
               "2", "2", "--width", "8", "--height", "8"]
        png = {n: os.path.join(tmp, f"cpu{n}.png") for n in (1, 2)}
        procs = {
            "cuda2": cli + ["--devices", "2"],
            "cpu1": cli + ["--device", "cpu", "--out", png[1]],
            "cpu2": cli + ["--device", "cpu", "--devices", "2", "--out",
                           png[2]]}
        procs = {k: subprocess.Popen(v, cwd=repo, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for k, v in procs.items()}
        try:
            t0 = time.perf_counter()
            rc = launch(_sharded_rank, [device, device], tmp,
                        timeout=SHARDED_TIMEOUT)
            world_s = time.perf_counter() - t0
            if rc != 0:
                _fail(f"multi-rank: a rank failed or hung (launch returned "
                      f"{rc})")
            print(f"multi-rank: 2 ranks on {device} over gloo, the world "
                  f"{world_s:.2f} s from spawn to exit; the ranks time-slice "
                  f"one card, so no time below is a scaling result; on "
                  f"{card}")
            for name, traversal, shape in SHARDED_CASES:
                walls = []
                for rank in range(2):
                    r = np.load(os.path.join(tmp, f"{name}.rank{rank}.npz"))
                    img = torch.from_numpy(r["img"]).to(device)
                    launches = json.loads(str(r["launches"]))
                    expected = json.loads(str(r["expected"]))
                    render_s, exchange_s, wall_s = r["seconds"].tolist()
                    walls.append(wall_s)
                    same = torch.equal(img, want[name])
                    print(f"multi-rank {name} ({traversal}, px {shape[0]} sp "
                          f"{shape[1]}) rank {rank}: render {render_s:.3f} s, "
                          f"exchange {exchange_s:.4f} s of {int(r['nbytes'])} "
                          f"bytes, launches {launches}; frame "
                          f"{'bitwise' if same else 'DIFFERS from'} the "
                          f"single-device one")
                    if not same:
                        _fail(f"multi-rank {name}: rank {rank}'s frame is "
                              "not the single-device frame")
                    if launches != expected:
                        _fail(f"multi-rank {name}: rank {rank} launched "
                              f"{launches}, expected {expected}")
                    if name != "c":
                        st = np.stack([s.cpu().numpy() for s in head_stats])
                        if not np.array_equal(r["stats"], st):
                            _fail(f"multi-rank {name}: rank {rank}'s "
                                  "TraceStats are not phase 4's")
                print(f"multi-rank {name}: wall {max(walls):.3f} s (the "
                      "slower rank, render and exchange) on "
                      f"{card}")
            # d.
            outs = {}
            for k, p in procs.items():
                out, err = p.communicate(timeout=SHARDED_TIMEOUT)
                outs[k] = (p.returncode, out, err)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rc, _, err = outs["cuda2"]
        named = f"need 2 CUDA devices; this machine has {count}"
        print(f"multi-rank d: render --devices 2 on {count} card(s) exited "
              f"{rc}: {err.strip().splitlines()[-1] if err.strip() else ''}")
        if rc == 0 or named not in err:
            _fail(f"render --devices 2 on {count} card(s) did not exit with "
                  f"an error naming both numbers (rc {rc})")
        for k in ("cpu1", "cpu2"):
            if outs[k][0] != 0:
                _fail(f"render {k}: exited {outs[k][0]}: {outs[k][2]}")
        with open(png[1], "rb") as f, open(png[2], "rb") as g:
            if f.read() != g.read():
                _fail("render --device cpu --devices 2 wrote another PNG "
                      "than --devices 1")
        print("multi-rank d: render --device cpu --devices 2 wrote the PNG "
              "of --devices 1, byte for byte")

    # e. the multichip dry run's two legs, through its entry point
    t0 = time.perf_counter()
    rc = dryrun_multichip(2, device, timeout=SHARDED_TIMEOUT)
    print(f"multi-rank e: dryrun_multichip(2) returned {rc} in "
          f"{time.perf_counter() - t0:.2f} s on {card}")
    if rc != 0:
        _fail(f"dryrun_multichip on two ranks of {device} returned {rc}")


# Phase 15: the oracle cases at these sizes (pixels a side)
ORACLE_SCENE_SIZE = 64
ORACLE_REALTIME_SIZE = 32
# the kernels each case must launch (the sphere scenes have no mesh)
ORACLE_KERNELS = {
    "pairs": ("pairs_closest", "pairs_shadow"),
    "pallas": ("pallas_closest", "pallas_shadow"),
    "realtime pairs": ("pairs_closest_smooth", "pairs_shadow"),
    "realtime pallas": ("pallas_closest", "pallas_shadow"),
}


def _oracle(device, card):
    """Phase 15 (module docstring)."""
    from raytracinggpu_tpu_torch.oracle import cases
    from raytracinggpu_tpu_torch.ops import _kernels

    def held(label, make, bound, kernels=()):
        t0 = time.perf_counter()
        case = make()
        _kernels.reset_launches()
        got, ref = cases.run(case)
        launched = {k: v for k, v in _kernels.LAUNCHES.items()
                    if v and k not in _kernels.DEPTH_STEP + _kernels.GLUE}
        share = cases.disagree(got, ref)
        print(f"oracle {label}: {share:.4%} of {len(got)} rays disagree "
              f"(bound {bound:.0%}), launches {launched}, "
              f"{time.perf_counter() - t0:.2f} s")
        if not share < bound:
            _fail(f"oracle {label}: {share:.2%} of the rays disagree")
        if not all(launched.get(k, 0) > 0 for k in kernels) or (
                not kernels and launched):
            _fail(f"oracle {label}: launches {launched}, expected "
                  f"{kernels or 'none'}")

    n, m = ORACLE_SCENE_SIZE, ORACLE_REALTIME_SIZE
    for seed in (7, 42, 1001):
        held(f"spheres seed {seed} ({n}x{n}, depth 4)",
             lambda: cases.sphere_case(seed, device, size=n),
             cases.SHARE["spheres"])
    for seed in (3, 99):
        for trav in ("pairs", "pallas"):
            held(f"mesh seed {seed} {trav} ({n}x{n}, 200 triangles)",
                 lambda: cases.mesh_case(seed, trav, device, size=n),
                 cases.SHARE["mesh"], ORACLE_KERNELS[trav])
    for trav in ("pairs", "pallas"):
        held(f"realtime smooth normals {trav} ({m}x{m})",
             lambda: cases.realtime_case(trav, device, size=m),
             cases.SHARE["realtime"], ORACLE_KERNELS[f"realtime {trav}"])
    frames = cases.smooth_frames(device, size=m)
    for trav in ("pallas", "pairs"):
        share = cases.smooth_disagree(frames[trav], frames["dense"])
        print(f"oracle smooth normals {trav} against dense ({m}x{m} frame): "
              f"{share:.4%} of the pixels disagree (bound "
              f"{cases.SMOOTH_SHARE:.0%})")
        if not share < cases.SMOOTH_SHARE:
            _fail(f"smooth normals {trav}: {share:.2%} off the dense frame")
    print(f"oracle cases on {card}")


def _native_phase(device, card, head_img):
    """Phase 16 (module docstring); ``head_img`` phase 4's frame."""
    import tempfile

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch import Renderer, native
    from raytracinggpu_tpu_torch.accel.bvh import build_bvh
    from raytracinggpu_tpu_torch.bench.big_mesh import soup_obj
    from raytracinggpu_tpu_torch.render.image_io import (
        read_png, tonemap, write_png)
    from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH, read_obj

    t0 = time.perf_counter()
    try:
        native.load()
    except RuntimeError as e:
        _fail(str(e))
    info = native.BUILD_INFO
    print(f"native: {info['compiler']}; "
          f"{'compiled' if info['compiled'] else 'cached'} "
          f"{os.path.relpath(info['library'])} in {info['seconds']:.2f} s "
          f"(build+load here {time.perf_counter() - t0:.2f} s)")

    def same(a, b, fields, what):
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(
                    x.view(np.uint8), y.view(np.uint8)):
                _fail(f"native {what}: {f} is not the numpy one")

    obj_fields = ("vertices", "normals", "uvs", "vtx", "nrm", "uv")
    bvh_fields = ("left", "right", "mn", "mx", "tri_start", "tri_end",
                  "skip", "order")
    for embed in (False, True):
        same(read_obj(CAT_OBJ_PATH, embed, native=True),
             read_obj(CAT_OBJ_PATH, embed, native=False), obj_fields,
             f"cat OBJ (embed_transform={embed})")
    print("native: the cat OBJ, with and without the embedded transform, "
          "bitwise the numpy parse")

    def clock(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        path = os.path.join(d, "soup.obj")
        soup_obj(path, BIG_TRIS)
        objs, secs = {}, {}
        for nat in (False, True):
            objs[nat], secs[nat] = clock(lambda: read_obj(path, native=nat))
        same(objs[True], objs[False], obj_fields, "soup OBJ")
        V, vtx = objs[False].vertices, objs[False].vtx
        A, B, C = (V[vtx[:, k]] for k in range(3))
        bvhs, bsecs = {}, {}
        for nat in (False, True):
            bvhs[nat], bsecs[nat] = clock(lambda: build_bvh(A, B, C,
                                                            native=nat))
        same(bvhs[True], bvhs[False], bvh_fields, "soup BVH")
        print(f"native: the {BIG_TRIS}-triangle soup: read_obj "
              f"{secs[False]:.3f} s numpy, {secs[True]:.3f} s native; "
              f"build_bvh (the reference midpoint tree, "
              f"{bvhs[True].n_nodes} nodes) {bsecs[False]:.3f} s numpy, "
              f"{bsecs[True]:.3f} s native; both bitwise")
        # bench/big_mesh.py's host_build_s: the Renderer's construction
        def soup_build():
            r = Renderer("array_bvh", obj_path=path, bvh_builder="lbvh",
                         device=device, **BIG_FRAME)
            torch.cuda.synchronize()
            return r.scene

        host, tabs = {}, {}
        saved = os.environ.get("RT_NATIVE")
        for nat in (False, True):
            os.environ["RT_NATIVE"] = "1" if nat else "0"
            try:
                tabs[nat], host[nat] = clock(soup_build)
            finally:
                if saved is None:
                    del os.environ["RT_NATIVE"]
                else:
                    os.environ["RT_NATIVE"] = saved
        for part in ("pairs_mesh", "pallas_mesh"):
            for a, b in zip(getattr(tabs[True], part),
                            getattr(tabs[False], part)):
                if torch.is_tensor(a) and not torch.equal(a, b):
                    _fail(f"native: the soup's {part} differ with "
                          "RT_NATIVE=0")
        print(f"native: the soup's host build (bench/big_mesh.py "
              f"host_build_s: Renderer, lbvh, {BIG_FRAME}) "
              f"{host[False]:.3f} s with RT_NATIVE=0, {host[True]:.3f} s "
              f"native (the lbvh builder is numpy either way: native parses "
              f"the OBJ); the tables bitwise; on {card}")
        del tabs
        img = tonemap(head_img)
        pngs = {nat: os.path.join(d, f"head_{nat}.png") for nat in (0, 1)}
        for nat, png in pngs.items():
            write_png(png, img, native=bool(nat))
        with open(pngs[0], "rb") as f, open(pngs[1], "rb") as g:
            if f.read() != g.read():
                _fail("native: the headline PNG differs from the numpy "
                      "writer's")
        if not np.array_equal(read_png(pngs[1]), img):
            _fail("native: the headline PNG does not read back")
        print(f"native: the headline image {img.shape} written as PNG, "
              "byte for byte the numpy writer's, read back equal")


# Phase 17: the gallery's quick rows run here
GALLERY_ROWS = ("array_bvh", "showcase", "realtime_512x512")
GALLERY_ABLATIONS = ("pallas_tiled_s64", "spp_fuse1", "bvh_skiplinks")
GALLERY_TIMEOUT = 600.0


def _gallery(card):
    """Phase 17 (module docstring)."""
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        cmd = [sys.executable, "-m", "raytracinggpu_tpu_torch.bench.gallery",
               "--quick", "--out", d, "--only", "frames,realtime,ablations",
               "--rows", ",".join(GALLERY_ROWS),
               "--ablation-rows", ",".join(GALLERY_ABLATIONS)]
        t0 = time.perf_counter()
        try:
            res = subprocess.run(cmd, cwd=repo, capture_output=True,
                                 text=True, timeout=GALLERY_TIMEOUT)
        except subprocess.TimeoutExpired:
            _fail(f"the gallery ran past {GALLERY_TIMEOUT} s")
        print(f"gallery: exit {res.returncode} in "
              f"{time.perf_counter() - t0:.2f} s")
        if res.returncode != 0:
            _fail(f"the gallery exited {res.returncode}:\n"
                  f"{res.stderr[-3000:]}")
        docs = {}
        for name, want in (("torch_results.json", GALLERY_ROWS),
                           ("torch_ablations.json", GALLERY_ABLATIONS)):
            with open(os.path.join(d, name)) as f:
                docs[name] = doc = json.load(f)
            if doc["card"] != card:
                _fail(f"gallery {name}: card {doc['card']!r}, not {card!r}")
            if tuple(doc["rows"]) != want:
                _fail(f"gallery {name}: rows {list(doc['rows'])}")
            for row, val in doc["rows"].items():
                if "error" in val:
                    _fail(f"gallery {name} {row}: {val['error']}")
                print(f"gallery {row}: {json.dumps(val)}")
        head = {k: v for k, v in docs["torch_results.json"].items()
                if k != "rows"}
        print(f"gallery files: {json.dumps(head)}")


def _ladder_frames(name, on, off, same, want):
    """18a, one scene: ``on()`` (the default config, tiers logged) and
    ``off()`` (the ladder off) with the counters zeroed before each; their
    results must be ``same`` and each launch ``want``."""
    import torch
    from raytracinggpu_tpu_torch.bench.ladder import TierLog
    from raytracinggpu_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    with TierLog() as log:
        a = on()
    torch.cuda.synchronize()
    c_on, c_off = {}, {}
    l_on = _launched(c_on)
    _kernels.reset_launches()
    b = off()
    torch.cuda.synchronize()
    l_off = _launched(c_off)
    expected = _none()
    expected.update(want)
    if l_on != expected or l_off != expected:
        _fail(f"ladder {name}: launches on {l_on}, off {l_off}, expected "
              f"{expected}")
    # the key runs only with the ladder on
    if c_on["compact_key"] != len(log.log) or c_off["compact_key"]:
        _fail(f"ladder {name}: compact_key launched {c_on['compact_key']} "
              f"times on ({len(log.log)} casts keyed), {c_off['compact_key']}"
              " off")
    if not same(a, b):
        _fail(f"ladder {name}: the frame with the ladder on differs from "
              "the frame with it off")
    if not log.log:
        _fail(f"ladder {name}: no cast ran the ladder")
    print(f"ladder {name}: the frame with the ladder on is bitwise the "
          f"frame with it off, TraceStats equal; launches {want} both ways, "
          f"of the culling {c_on} on and {c_off} off")
    for line in log.summary():
        print(f"  {line}")
    return log


def _ladder_phase(device, card, err, head, rt_scene, soup):
    """Phase 18 (module docstring).  ``head`` phase 4's (config, tables,
    camera), ``rt_scene`` phase 7's (config, tables), ``soup`` phase 10's
    (config, tables)."""
    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.render.pipeline import (
        render_frame, render_preset_frame)
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    hcfg, htab, cam = head
    rcfg, rtab = rt_scene
    scfg, stab = soup
    acfg, atab = build_preset("realtime", device, animate_mesh=True)
    off = _ladder_off
    t_eq = lambda a, b: torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
    n_eq = lambda a, b: np.array_equal(a[0], b[0]) and all(
        np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    st_eq = lambda a, b: torch.equal(a[0].accum, b[0].accum) and \
        torch.equal(a[1], b[1])

    # a. frames, bitwise, with the tier each cast took
    head_frame = lambda c, seed=0: render_frame(htab, c, cam,
                                                PRNGKey(seed, device))
    step1 = lambda tab, c: rt.step(tab, c, rt.init_state(c, tab, seed=0))
    _ladder_frames("headline (array_bvh 512x512 spp32 d5)",
                   lambda: head_frame(hcfg), lambda: head_frame(off(hcfg)),
                   t_eq, dict(pairs_closest=80, pairs_shadow=80))
    _ladder_frames("realtime frame 1", lambda: step1(rtab, rcfg),
                   lambda: step1(rtab, off(rcfg)), st_eq,
                   dict(pairs_closest_smooth=30, pairs_shadow=30))
    _ladder_frames("animated frame 1", lambda: step1(atab, acfg),
                   lambda: step1(atab, off(acfg)), st_eq,
                   dict(pairs_closest_smooth=30, pairs_shadow=30))
    nc = stab.pairs_mesh.tile_aabb.shape[0]
    knc = -(-nc // scfg.pairs_key_coarse)
    slog = _ladder_frames(
        f"soup (512x512 spp4 d2, {nc} tiles, key_coarse "
        f"{scfg.pairs_key_coarse}: {knc} key boxes)",
        lambda: render_preset_frame(stab, scfg, seed=0),
        lambda: render_preset_frame(stab, off(scfg), seed=0), n_eq,
        dict(pairs_closest=4, pairs_shadow=4))
    modes = {pt._key_mode(knc, e["R"]) for e in slog.log}
    print(f"ladder soup: key (mode, shift) {sorted(modes)}")
    if scfg.pairs_key_coarse != 32 or {m for m, _ in modes} != {1}:
        _fail(f"the soup's key: key_coarse {scfg.pairs_key_coarse}, modes "
              f"{modes}; expected 32 and mode 1")

    # b. the kernels on compacted casts, depths 1 and 2, against their plain
    # versions
    timing = {}
    for label, render, plan, tab in (
            ("array_bvh", lambda: head_frame(hcfg),
             {"pairs_closest": (), "pairs_shadow": ()}, htab.pairs_mesh),
            ("realtime", lambda: step1(rtab, rcfg),
             {"pairs_closest_smooth": (), "pairs_shadow": ()},
             rtab.pairs_mesh)):
        kept, _ = _capture_casts(render, 3)
        kept = {k: v[1:] for k, v in kept.items()}
        c = hcfg if label == "array_bvh" else rcfg
        casts = _check_casts(kept, plan, tab, c, err,
                             f"{label} (the ladder on)", depths=(1, 2))
        _time_casts(casts, timing, card, depths=(1, 2))

    # c. the anchors ran with the ladder on (phases 6, 7b, 13b)
    print("ladder anchors: phases 6 (production), 7b (realtime) and 13b "
          "(animated) rendered with the default config, the ladder on")


def _plain_culling(fn):
    """fn() with the plain culling of ops/pairs_trace patched in for
    ``_pair_bits``, ``compact_bits`` and ``_compact_key`` (torch ops); the
    dispatching functions are put back afterwards."""
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    saved = pt._pair_bits, pt.compact_bits, pt._compact_key
    pt._pair_bits, pt.compact_bits, pt._compact_key = (
        pt.pair_bits_plain, pt.compact_bits_plain, pt.compact_key_plain)
    try:
        return fn()
    finally:
        pt._pair_bits, pt.compact_bits, pt._compact_key = saved


def _hold_culling(kept, where, err):
    """19a/b: each kept call's kernel bitwise its plain version."""
    import torch
    from raytracinggpu_tpu_torch.bench.depth_step import (
        flatten, max_abs_err, same_bits)
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    for label, args in kept.get("compact_bits", ()):
        keys, C, _, O, _, nc, subg, (boxes, _), cap, active = args
        got = flatten(_kernels.compact_bits(*args))
        want = flatten(pt.compact_bits_plain(*args))
        torch.cuda.synchronize()
        ok = same_bits(got, want)
        e = 0.0 if ok else max_abs_err(got, want)
        err["compact_bits"] = max(err["compact_bits"], e)
        print(f"culling {where} {label}: compact_bits on C {C} of "
              f"{O.x.shape[0]} rays, subgroup {subg}, {boxes.shape[0]} "
              f"member boxes of {nc} tiles, cap {cap is not None}, active "
              f"{active is not None}: "
              + ("bitwise equal" if ok else f"DIFFER (max abs {e})"))
        if not ok:
            _fail(f"compact_bits differs from its plain version on {where} "
                  f"{label}")
    for label, args in kept["pair_bits"]:
        O, _, nc, subg, (boxes, _), cap, active = args
        got = _kernels.pair_bits(*args)
        want = pt.pair_bits_plain(*args)
        torch.cuda.synchronize()
        e = _max_abs_err(got, want)
        err["pair_bits"] = max(err["pair_bits"], e)
        n_set = int(sum(int(((want.to(torch.int64) >> b) & 1).sum())
                        for b in range(32)))
        print(f"culling {where} {label}: pair_bits on {O.x.shape[0]} rays, "
              f"subgroup {subg}, {boxes.shape[0]} member boxes of {nc} tiles,"
              f" words {tuple(want.shape)}, cap {cap is not None}, active "
              f"{active is not None}, {n_set} bits set: "
              + ("bitwise equal" if torch.equal(got, want)
                 else f"DIFFER (max abs {e})"))
        if not torch.equal(got, want):
            _fail(f"pair_bits differs from its plain version on {where} "
                  f"{label}")
    for label, args in kept["compact_key"]:
        O, _, boxes, nc, cap, active, valid_n = args
        skey, n_act, shift = pt._compact_key(*args)
        wkey, wn, wshift = pt.compact_key_plain(*args)
        torch.cuda.synchronize()
        e = _max_abs_err(skey, wkey)
        err["compact_key"] = max(err["compact_key"], e)
        same = (torch.equal(skey, wkey) and n_act.dtype == wn.dtype
                and int(n_act) == int(wn) and shift == wshift)
        mode = pt._key_mode(nc, O.x.shape[0])[0]
        print(f"culling {where} {label}: compact_key on {O.x.shape[0]} rays "
              f"(valid {valid_n}), {nc} key boxes, mode {mode}, shift "
              f"{shift}, n_act {int(wn)}: "
              + ("bitwise equal" if same else f"DIFFER (max abs {e}, n_act "
                 f"{int(n_act)})"))
        if not same:
            _fail(f"compact_key differs from its plain version on {where} "
                  f"{label}")


def _culling_phase(device, card, err, head, head_out, rt_scene, soup):
    """Phase 19 (module docstring).  ``head`` phase 4's (config, tables,
    camera), ``head_out`` its (image, TraceStats), ``rt_scene`` phase 7's
    (config, tables), ``soup`` phase 10's (config, tables).  Returns
    {kernel: (ms, plain_ms, bound_ms, bound_by)} on the cat's depth-1
    closest cast."""
    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.bench.cull import (
        adversarial, call_bound, index_cases)
    from raytracinggpu_tpu_torch.bench.cull_design import (
        capture, graph_nodes, hold_index_cases, row_args)
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.render.pipeline import (
        render_frame, render_preset_frame)
    from raytracinggpu_tpu_torch.utils.profiling import device_kernels

    hcfg, htab, cam = head
    rcfg, rtab = rt_scene
    scfg, stab = soup
    head_frame = lambda c, seed=0: render_frame(htab, c, cam,
                                                PRNGKey(seed, device))
    step1 = lambda: rt.step(rtab, rcfg, rt.init_state(rcfg, rtab, seed=0))
    soup_frame = lambda: render_preset_frame(stab, scfg, seed=0)

    # a. bitwise on the frames' own casts
    captured = {}
    for where, render, n_bits, n_keys, n_compact in (
            ("headline, the ladder off", lambda: head_frame(
                _ladder_off(hcfg)), 4, 0, 0),
            ("headline", lambda: head_frame(hcfg), 6, 4, 4),
            ("realtime frame 1", step1, 6, 4, 4),
            ("soup", soup_frame, 4, 2, 0)):
        kept, _ = capture(render, n_bits, n_keys, 0, n_compact)
        torch.cuda.synchronize()
        if len(kept["pair_bits"]) != n_bits \
                or len(kept["compact_key"]) != n_keys \
                or len(kept["compact_bits"]) != n_compact:
            _fail(f"culling {where}: kept {len(kept['pair_bits'])} casts, "
                  f"{len(kept['compact_key'])} keys and "
                  f"{len(kept['compact_bits'])} compacted casts, expected "
                  f"{n_bits}, {n_keys} and {n_compact}")
        _hold_culling(kept, where, err)
        captured[where] = kept
    soup_subg = {a[3] for _, a in captured["soup"]["pair_bits"]}
    soup_w = {-(-a[2] // 32) for _, a in captured["soup"]["pair_bits"]}
    soup_key = {(a[3], pt._key_mode(a[3], a[0].x.shape[0])[0])
                for _, a in captured["soup"]["compact_key"]}
    print(f"culling soup: subgroups {soup_subg}, words {soup_w}, key (boxes, "
          f"mode) {soup_key}")
    if soup_subg != {16} or soup_w != {65} or soup_key != {(65, 1)}:
        _fail("the soup's casts are not subgroup 16, 65 words, key mode 1 "
              "over 65 unions")

    # b. adversarial rays (bench/cull.py), bitwise
    R, nb, nt = 65536, 1100, 300
    for seed in (0, 1):
        O, d, boxes, tiles, cap, act = (
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in adversarial(seed, R, nb, nt))
        O, u = Vec3(*O), Vec3(*d)
        combos = ((None, None), (cap, None), (None, act), (cap, act))
        kept = {"pair_bits": [(f"seed {seed}", (O, u, nt, subg,
                                                (boxes, tiles), c, a))
                              for subg in (16, 32, 64) for c, a in combos],
                "compact_key": [(f"seed {seed}", (O, u, kb.contiguous(), n,
                                                  c, a, R - 7))
                                for kb, n in ((boxes[:40], 40), (boxes, nb))
                                for c, a in combos]}
        _hold_culling(kept, "adversarial", err)

    # c. whole frames, bitwise the frames with the plain culling patched in
    def counted(fn):
        _kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(_kernels.LAUNCHES)

    t_eq = lambda a, b: torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
    n_eq = lambda a, b: np.array_equal(a[0], b[0]) and all(
        np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    st_eq = lambda a, b: torch.equal(a[0].accum, b[0].accum) and \
        torch.equal(a[1], b[1])
    for name, fn, same, kern_out in (
            ("headline", lambda: head_frame(hcfg), t_eq, head_out),
            ("realtime frame 1", step1, st_eq, None),
            ("soup", soup_frame, n_eq, None)):
        if kern_out is None:
            kern_out, l_kern = counted(fn)
        else:   # phase 4's frame, counted there
            l_kern = None
        plain_out, l_plain = counted(lambda: _plain_culling(fn))
        if l_plain["pair_bits"] or l_plain["compact_key"] \
                or l_plain["compact_bits"]:
            _fail(f"culling frames {name}: the patched frame launched "
                  f"{l_plain}")
        if l_kern is not None and (
                l_kern["pair_bits"] + l_kern["compact_bits"]
                != sum(l_kern[k] for k in _PAIRS_KERNELS)
                or not l_kern["compact_key"]
                or {k: v for k, v in l_kern.items()
                    if k not in _kernels.CULLING}
                != {k: v for k, v in l_plain.items()
                    if k not in _kernels.CULLING}):
            _fail(f"culling frames {name}: launches {l_kern} through the "
                  f"kernels, {l_plain} with the plain culling")
        if not same(kern_out, plain_out):
            _fail(f"culling frames {name}: the frame through the culling "
                  "kernels differs from the frame with the plain culling")
        print(f"culling frames {name}: bitwise the frame with the plain "
              f"culling patched in (image and TraceStats); launches with "
              f"the plain culling {l_plain}")

    # d. timings: the kernel replayed from a CUDA graph and eager, its
    # plain version eager, the bound (pair_bits on the compacted cast: on
    # the C rays its compact_bits call culls, bench/cull_design.row_args)
    first = lambda where, name, label: row_args(captured, where, name,
                                                label)

    timing = {}
    for row, where, name, label in (
            ("cat depth-1 closest, full width", "headline, the ladder off",
             "pair_bits", "depth 1 closest"),
            ("cat depth-1 shadow, full width", "headline, the ladder off",
             "pair_bits", "depth 1 shadow"),
            ("cat depth-1 closest, compacted", "headline", "pair_bits",
             "depth 1 closest"),
            ("cat depth-1 closest", "headline", "compact_key",
             "depth 1 closest"),
            ("soup depth-1 closest", "soup", "pair_bits", "depth 1 closest"),
            ("soup depth-1 closest", "soup", "compact_key",
             "depth 1 closest")):
        args = first(where, name, label)
        if name == "pair_bits":
            kern = lambda: _kernels.pair_bits(*args)
            plain = lambda: pt.pair_bits_plain(*args)
            n_boxes = args[4][0].shape[0]
        else:
            kern = lambda: pt._compact_key(*args)
            plain = lambda: pt.compact_key_plain(*args)
            n_boxes = args[3]
        ms = _time_ms(kern, 50, graph=True)
        cold_ms = _time_ms(kern, 50, graph=True, flush_l2=True)
        eager_ms = _time_ms(kern, 20)
        plain_ms = _time_ms(plain, 3)
        bound, by, floor = call_bound(name, args, kern())
        if row == "cat depth-1 closest, full width" or (
                name == "compact_key" and row.startswith("cat")):
            timing[name] = (ms, plain_ms, bound, by)
        print(f"timing {name} on the {row} cast ({args[0].x.shape[0]} rays, "
              f"{n_boxes} boxes): kernel {ms:.4f} ms (graph replay; eager "
              f"{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}; roofline share {bound / ms:.1%}), "
              f"no-FMA floor {floor:.4f} ms ({floor / ms:.1%}) on {card}")

    # the kernels a headline frame launches, through the culling kernels and
    # with the plain culling (utils/profiling.device_kernels), and frame
    # times in turns
    for label, fn in (("culling kernels", lambda: head_frame(hcfg, 1)),
                      ("plain culling", lambda: _plain_culling(
                          lambda: head_frame(hcfg, 1)))):
        k = device_kernels(fn, top=6)
        print(f"culling headline kernels ({label}): {k['kernels']} kernels, "
              f"{k['kernel_ms']:.1f} ms of device time a frame on {card}")
        for e in k["by_name"]:
            print(f"  {e['ms']:9.1f} ms {e['count']:7d}x  {e['name']}")
    walls = {"kernels": [], "plain": []}
    for way in ("kernels", "plain", "plain", "kernels"):
        fn = (lambda: head_frame(hcfg, 2)) if way == "kernels" else (
            lambda: _plain_culling(lambda: head_frame(hcfg, 2)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[way].append(time.perf_counter() - t0)
    print(f"culling headline frame (host clock, in turns): through the "
          f"kernels {[round(t, 4) for t in walls['kernels']]} s, with the "
          f"plain culling {[round(t, 4) for t in walls['plain']]} s on "
          f"{card}")

    # e. the kernels' index math (bench/cull.index_cases), through the
    # wrappers and at every rays-a-thread the kernels take, bitwise
    held = hold_index_cases([c for c in index_cases(device, n_sg=1037)
                             if c[1] != "tile_lists"])  # phase 20's
    bad = [(label, k) for label, k, ok in held if not ok]
    if bad:
        _fail(f"culling index cases differ from the plain versions: {bad}")
    print(f"culling index cases: {len(held)} calls on "
          f"{len({label for label, _, _ in held})} cases (subgroups 2-512, "
          "rays no multiple of a block's, members outside the tiles, 157 "
          "words in passes, keys past a staging chunk), each bitwise the "
          "plain version")

    # f. the key's count in one launch: one kernel a call (no memset), and
    # n_act right over three calls in a row and two replays of one graph
    args = first("headline", "compact_key", "depth 1 closest")
    want = int(pt.compact_key_plain(*args)[1])
    one = graph_nodes(lambda: pt._compact_key(*args))
    in_row = [int(pt._compact_key(*args)[1]) for _ in range(3)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pt._compact_key(*args)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(int(captured[1]))
    print(f"culling key count: one call captures {len(one)} graph node(s) "
          f"of types {one} (0 a kernel, 2 a memset); n_act {in_row} in a "
          f"row, {replays} from graph replays, plain {want}")
    if one != [0] or in_row != [want] * 3 or replays != [want] * 2:
        _fail("compact_key is not one launch a call, or its n_act is wrong "
              "across calls or graph replays")
    return timing


def _plain_tile_lists(fn):
    """fn() with ops/pallas_trace's plain tiled culling patched in for
    ``_block_active_tiles`` (the parent's path: torch ops), put back
    afterwards."""
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    saved = pat._block_active_tiles
    pat._block_active_tiles = pat.block_active_tiles_plain
    try:
        return fn()
    finally:
        pat._block_active_tiles = saved


def _hold_tile_lists(kept, where, err, quiet=False):
    """20a: each kept call's kernel bitwise its plain version; ``quiet``
    prints one line for all of them."""
    import torch
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    listed = 0
    for label, args in kept:
        O, _, aabb, nt, cap, subg = args
        got = _kernels.tile_lists(*args)
        want = pat.block_active_tiles_plain(*args)
        torch.cuda.synchronize()
        e = _max_abs_err(got, want)
        err["tile_lists"] = max(err["tile_lists"], e)
        if not torch.equal(got, want):
            _fail(f"tile_lists differs from its plain version on {where} "
                  f"{label} (subgroup {subg}, cap {cap is not None}, max "
                  f"abs {e})")
        listed += int(want[:, 0].sum())
        if quiet:
            continue
        valid = int((aabb[:nt, 0] <= aabb[:nt, 3]).sum())
        print(f"tile culling {where} {label}: tile_lists on {O.x.shape[0]} "
              f"rays, subgroup {subg}, {nt} tiles ({valid} valid), cap "
              f"{cap is not None}, rows {tuple(want.shape)}, "
              f"{int(want[:, 0].sum())} (subgroup, tile) pairs listed: "
              "bitwise equal")
    if quiet:
        print(f"tile culling {where} {kept[0][0]}: {len(kept)} calls, "
              f"{listed} (subgroup, tile) pairs listed: each bitwise equal")


def _tile_culling_phase(device, card, err, soup):
    """Phase 20 (module docstring).  ``soup`` phase 10's (config, tables).
    Returns ({"tile_lists": (ms, plain_ms, bound_ms, bound_by)} on the
    pallas headline's depth-1 closest cast, the launches of a pallas
    headline frame)."""
    import dataclasses

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.bench.cull import (
        TILE_SUBGROUPS, adversarial_tiles, call_bound, index_cases)
    from raytracinggpu_tpu_torch.bench.cull_design import (
        capture, hold_index_cases, launch)
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, rays_per_frame, render_frame, render_preset_frame)
    from raytracinggpu_tpu_torch.scene.presets import build_preset
    from raytracinggpu_tpu_torch.utils.profiling import device_kernels

    hcfg, htab = build_preset("array_bvh", device, width=512, height=512,
                              spp=32, max_depth=5, traversal="pallas")
    cam = Camera.default(hcfg, device)
    head_frame = lambda seed=0: render_frame(htab, hcfg, cam,
                                             PRNGKey(seed, device))
    scfg, stab = soup
    scfg = dataclasses.replace(scfg, traversal="pallas")
    soup_frame = lambda seed=0: render_preset_frame(stab, scfg, seed=seed)
    acfg, atab = build_preset("realtime", device, animate_mesh=True,
                              traversal="pallas")
    posed = lambda: rt.step(atab, acfg, rt.init_state(acfg, atab, seed=0),
                            mesh_speed=ANIM_MESH_SPEED)

    # a. bitwise on the frames' own calls
    captured = {}
    for where, render, n in (
            ("pallas headline", head_frame, 4),
            ("soup pallas", soup_frame, 8),
            ("animated pallas frame 1 (posed)", posed, 1)):
        kept, _ = capture(render, 0, 0, n)
        torch.cuda.synchronize()
        if len(kept["tile_lists"]) != n:
            _fail(f"tile culling {where}: kept {len(kept['tile_lists'])} "
                  f"calls, expected {n}")
        _hold_tile_lists(kept["tile_lists"], where, err)
        captured[where] = kept["tile_lists"]
    soup_nt = {a[3] for _, a in captured["soup pallas"]}
    print(f"tile culling soup: tiles {soup_nt}, subgroup {scfg.pallas_subgroup}")

    # bench/cull.py's adversarial tables, and the tiled index cases (word
    # passes, a table past 131,072 tiles, every subgroup, every
    # rays-a-thread)
    lib = _kernels.load()
    R = 65536
    for nt in (4, 31, 32, 33, 126, 127, 300):
        O, d, aabb, cap = (torch.from_numpy(np.ascontiguousarray(a)).to(
            device) for a in adversarial_tiles(nt, R, nt))
        O, u = Vec3(*O), Vec3(*d)
        _hold_tile_lists([(f"{nt} tiles ({int((aabb[:, 0] <= aabb[:, 3])
                                              .sum())} valid), {R} rays, "
                           "subgroups 1-128 with and without cap",
                           (O, u, aabb, nt, c, subg))
                          for subg in TILE_SUBGROUPS for c in (None, cap)],
                         "adversarial", err, quiet=True)
        # the same tables through two launches forced (the words through
        # device memory, then the rows), bitwise
        for subg in TILE_SUBGROUPS:
            for c in (None, cap):
                args = (O, u, aabb, nt, c, subg)
                if not torch.equal(launch(lib, "tile_lists", args,
                                          ko=(0, 0)),
                                   pat.block_active_tiles_plain(*args)):
                    _fail(f"tile_lists in two launches differs from its "
                          f"plain version on {nt} tiles, subgroup {subg}")
    tiled_cases = [c for c in index_cases(device, n_sg=1037)
                   if c[1] == "tile_lists"]
    held = hold_index_cases(tiled_cases)
    bad = [(label, k) for label, k, ok in held if not ok]
    if bad:
        _fail(f"tile culling index cases differ from the plain version: "
              f"{bad}")
    # the frames' casts run in one launch (no scratch); past one pass of a
    # block's words (140,000 tiles; 5,000 at subgroup 1), two
    one = {(a[0].x.shape[0], a[5], a[3], lib.rt_tile_lists_scratch(
        a[0].x.shape[0], a[5], a[3], 0, 1))
        for calls in captured.values() for _, a in calls}
    wide = {(c[2][3], c[2][5], lib.rt_tile_lists_scratch(
        c[2][0].x.shape[0], c[2][5], c[2][3], 0, 1))
        for c in tiled_cases if c[2][3] > 300}
    print(f"tile culling launches: the frames' casts (rays, subgroup, "
          f"tiles, scratch words) {sorted(one)}; the wide tables (tiles, "
          f"subgroup, scratch words) {sorted(wide)}")
    if any(n for *_, n in one) or not all(
            n > 0 for nt, subg, n in wide if nt > 4096 * 32 or subg == 1):
        _fail("tile culling: a frame's cast does not run in one launch, or "
              "a table past one pass of words does")
    print(f"tile culling index cases: {len(held)} calls on "
          f"{len({label for label, _, _ in held})} cases (subgroups 1-128 "
          "over 1,037 subgroups, 5,000 tiles in passes, 140,000 tiles, "
          "every rays-a-thread), each bitwise the plain version")

    # b. whole frames, bitwise the frames with the plain culling patched in
    def counted(fn):
        _kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(_kernels.LAUNCHES)

    t_eq = lambda a, b: torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
    n_eq = lambda a, b: np.array_equal(a[0], b[0]) and all(
        np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    frame_launches = None
    for name, fn, same in (("pallas headline", head_frame, t_eq),
                           ("soup pallas", soup_frame, n_eq)):
        kern_out, l_kern = counted(fn)
        plain_out, l_plain = counted(lambda: _plain_tile_lists(fn))
        tiled = l_kern["pallas_closest"] + l_kern["pallas_shadow"]
        other = lambda d: {k: v for k, v in d.items() if k != "tile_lists"}
        if l_plain["tile_lists"] or l_kern["tile_lists"] != tiled \
                or not tiled or other(l_kern) != other(l_plain):
            _fail(f"tile culling frames {name}: launches {l_kern} through "
                  f"the kernel, {l_plain} with the plain culling")
        if not same(kern_out, plain_out):
            _fail(f"tile culling frames {name}: the frame through the "
                  "kernel differs from the frame with the plain culling")
        print(f"tile culling frames {name}: bitwise the frame with the "
              f"plain culling patched in (image and TraceStats); launches "
              f"{ {k: v for k, v in l_kern.items() if v} } through the "
              f"kernel, tile_lists {l_plain['tile_lists']} with the plain "
              "culling")
        if frame_launches is None:
            frame_launches = l_kern

    # c. timings: the kernel replayed from a CUDA graph and eager, its
    # plain version eager, the bound and the no-FMA floor
    first = lambda where, label: next(a for lab, a in captured[where]
                                      if lab == label)
    timing = {}
    for row, where, label in (
            ("cat pallas depth-1 closest", "pallas headline",
             "depth 1 closest"),
            ("cat pallas depth-1 shadow", "pallas headline",
             "depth 1 shadow"),
            ("soup pallas depth-1 closest", "soup pallas",
             "depth 1 closest")):
        args = first(where, label)
        kern = lambda: _kernels.tile_lists(*args)
        plain = lambda: pat.block_active_tiles_plain(*args)
        ms = _time_ms(kern, 50, graph=True)
        cold_ms = _time_ms(kern, 50, graph=True, flush_l2=True)
        eager_ms = _time_ms(kern, 20)
        plain_ms = _time_ms(plain, 3)
        bound, by, floor = call_bound("tile_lists", args, kern())
        if row == "cat pallas depth-1 closest":
            timing["tile_lists"] = (ms, plain_ms, bound, by)
        nt = args[3]
        valid = int((args[2][:nt, 0] <= args[2][:nt, 3]).sum())
        print(f"timing tile_lists on the {row} cast ({args[0].x.shape[0]} "
              f"rays, {valid} valid of {nt} tiles, subgroup {args[5]}): "
              f"kernel {ms:.4f} ms (graph replay; eager {eager_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"roofline share {bound / ms:.1%}), no-FMA floor "
              f"{floor:.4f} ms ({floor / ms:.1%}) on {card}")

    # the kernels a pallas headline frame launches both ways, the two
    # frames' host-clock rate in turns, the soup frame's peak memory
    for label, fn in (("the kernel", lambda: head_frame(1)),
                      ("plain culling",
                       lambda: _plain_tile_lists(lambda: head_frame(1)))):
        k = device_kernels(fn, top=6)
        print(f"tile culling pallas headline kernels ({label}): "
              f"{k['kernels']} kernels, {k['kernel_ms']:.1f} ms of device "
              f"time a frame on {card}")
        for e in k["by_name"]:
            print(f"  {e['ms']:9.1f} ms {e['count']:7d}x  {e['name']}")
    for name, fn, cfg in (("pallas headline", head_frame, hcfg),
                          ("soup pallas", soup_frame, scfg)):
        walls = {"kernel": [], "plain": []}
        for way in ("kernel", "plain", "plain", "kernel") * 2:
            call = (lambda: fn(2)) if way == "kernel" else (
                lambda: _plain_tile_lists(lambda: fn(2)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls[way].append(time.perf_counter() - t0)
        rate = {w: [round(rays_per_frame(cfg) / t / 1e6, 3) for t in ts]
                for w, ts in walls.items()}
        med = {w: sorted(r)[len(r) // 2] for w, r in rate.items()}
        print(f"tile culling {name} frame (host clock, in turns): through "
              f"the kernel {[round(t, 4) for t in walls['kernel']]} s "
              f"({rate['kernel']} Mray/s, median {med['kernel']}), with the "
              f"plain culling {[round(t, 4) for t in walls['plain']]} s "
              f"({rate['plain']} Mray/s, median {med['plain']}) on {card}")
    # the process's peak, and the frame's own: the peak over what earlier
    # phases still hold
    for way, fn in (("the kernel", soup_frame), ("the plain culling",
                    lambda: _plain_tile_lists(soup_frame))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"tile culling soup pallas frame peak memory through {way}: "
              f"{peak / 2**20:.1f} MiB (max_memory_allocated), "
              f"{(peak - held) / 2**20:.1f} MiB over the {held / 2**20:.1f} "
              f"MiB held before the frame, on {card}")
    return timing, frame_launches, (hcfg, htab)


# Phase 21: the glue left between the kernels (outside the mesh casts and
# the kernels of csrc/wavefront.cu) of the headline frame, at most
DEPTH_STEP_GLUE = 20   # launches a depth step
SAMPLE_GLUE = 10       # launches a sample, outside rt_primary_rays
PARENT_LAUNCHES = (93_579, 93_930)  # the headline frame before (PERF.md)


def _depth_step_phase(device, card, err, head, rt_scene, pallas_head,
                      soup):
    """Phase 21 (module docstring).  ``head`` phase 4's (config, tables,
    camera, depth steps a frame), ``rt_scene`` phase 7's (config, tables), ``pallas_head`` phase
    20's (config, tables), ``soup`` phase 10's (config, tables).  Returns
    ({kernel: (ms, plain_ms, bound_ms, bound_by)}, the headline frame's
    launches of the four kernels)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.bench import depth_step as ds
    from raytracinggpu_tpu_torch.bench.sphere_scatter_design import (
        disasm, sass_report)
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.render.pipeline import (
        rays_per_frame, render_frame, render_preset_frame)
    from raytracinggpu_tpu_torch.scene.presets import build_preset
    from raytracinggpu_tpu_torch.utils.profiling import device_kernels

    # the library's SASS for d, read (cuobjdump, seconds) while a-c run
    pool = ThreadPoolExecutor(1)
    sass = pool.submit(disasm, _kernels.BUILD_INFO["library"])
    pool.shutdown(wait=False)
    hcfg, htab, cam, n_steps = head
    rcfg, rtab = rt_scene
    pcfg, ptab = pallas_head
    scfg, stab = soup
    acfg, atab = build_preset("realtime", device, animate_mesh=True)
    ccfg, ctab = build_preset("showcase", device, width=512, height=512,
                              spp=8, max_depth=5)
    head_frame = lambda seed=0: render_frame(htab, hcfg, cam,
                                             PRNGKey(seed, device))
    frames = {
        "headline": head_frame,
        "realtime frame 1": lambda: rt.step(
            rtab, rcfg, rt.init_state(rcfg, rtab, seed=0)),
        "animated frame 1": lambda: rt.step(
            atab, acfg, rt.init_state(acfg, atab, seed=0),
            mesh_speed=ANIM_MESH_SPEED),
        "showcase 512x512 spp8 d5": lambda: render_preset_frame(ctab, ccfg,
                                                                 0),
        "pallas headline": lambda: render_frame(
            ptab, pcfg, cam, PRNGKey(0, device)),
        "soup": lambda: render_preset_frame(stab, scfg, seed=0),
    }

    # a. bitwise on the calls the frames make (depths 0 and 1 of the first
    # cast, samples 0 and 1), then on the hard lanes
    outs = {}
    for where, fn in frames.items():
        kept, outs[where] = ds.capture(fn)
        torch.cuda.synchronize()
        held = ds.hold(kept, where, err)
        if not all(r[-1] for r in held):
            _fail(f"depth step {where}: a kernel differs from its plain "
                  "version")
    t_hard = t_edge = 0.0
    for edge_seed, (where, (tab, cfg)) in enumerate((
            ("headline scene", (htab, hcfg)),
            ("showcase scene", (ctab, ccfg)),
            ("realtime scene", (rtab, rcfg)))):
        t0 = time.perf_counter()
        for seed in (0, 1):
            if not ds.hold_calls(ds.adversarial_calls(tab, cfg, R=65536,
                                                      seed=seed),
                                 f"{where} seed {seed}", err):
                _fail(f"depth step {where}: a kernel differs from its "
                      "plain version on the hard lanes")
        t1 = time.perf_counter()
        # the edges of rt_sphere_hit's fast loop, and its exact path
        if not ds.hold_calls(ds.sphere_edge_calls(tab.spheres,
                                                  seed=edge_seed),
                             f"{where} seed {edge_seed}", err):
            _fail(f"depth step {where}: sphere_hit differs from its "
                  "plain version on the edge lanes")
        t_hard += t1 - t0
        t_edge += time.perf_counter() - t1
    print(f"depth step: the hard lanes held in {t_hard:.2f} s, the sphere "
          f"edge lanes in {t_edge:.2f} s")

    # the identities of rt_sphere_hit's loop over every f32 bit pattern
    t0 = time.perf_counter()
    ids = _kernels.f32_identities(device=device)
    torch.cuda.synchronize()
    print(f"depth step: the sphere loop's identities over all 2^32 f32 "
          f"patterns in {time.perf_counter() - t0:.3f} s: {ids} on {card}")
    if ids["patterns"] != 2**32 or ids["sqrt_differs"] \
            or ids["round_differs"] or ids["narrow_differs"] \
            or not ids["accepted"]:
        _fail(f"depth step: an identity of the sphere loop fails: {ids}")

    # b. whole frames, bitwise the frames with the plain stages patched in
    t_eq = lambda a, b: torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
    n_eq = lambda a, b: np.array_equal(a[0], b[0]) and all(
        np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    st_eq = lambda a, b: torch.equal(a[0].accum, b[0].accum) and \
        torch.equal(a[1], b[1])
    for where, same in (("headline", t_eq), ("realtime frame 1", st_eq),
                        ("showcase 512x512 spp8 d5", n_eq),
                        ("pallas headline", t_eq)):
        with ds.plain_stages():
            _kernels.reset_launches()
            plain = frames[where]()
            torch.cuda.synchronize()
            launched = {k: _kernels.LAUNCHES[k] for k in _kernels.DEPTH_STEP}
        if any(launched.values()) or not same(outs[where], plain):
            _fail(f"depth step frames {where}: differs from the frame with "
                  f"the plain stages, or that launched {launched}")
        print(f"depth step frames {where}: bitwise the frame with the plain "
              "stages patched in (image and TraceStats)")

    # c. launches of a headline frame: in all, with the mesh casts replayed
    # (what is left: the four kernels and the glue) and with the traces
    # replayed (what is left: the primary rays and the per-sample glue)
    n_samples = hcfg.spp
    counted = {}
    for label, targets in (("all", ()), ("mesh casts replayed",
                                         ds.MESH_CASTS),
                           ("traces replayed", ds.TRACES)):
        record, replay = ds.record_replay(targets)
        with record():
            want = head_frame(1)
        with replay():
            _kernels.reset_launches()
            box = {}
            k = device_kernels(lambda: box.update(out=head_frame(1)), top=6)
            torch.cuda.synchronize()
            depth = {}
            launched = _launched(depth=depth)
        if not (torch.equal(box["out"][0], want[0])
                and all(torch.equal(x, y)
                        for x, y in zip(box["out"][1], want[1]))):
            _fail(f"depth step launches ({label}): the replayed frame "
                  "differs")
        counted[label] = (k, depth, launched)
        print(f"depth step headline launches ({label}): {k['kernels']} "
              f"device operations, {k['kernel_ms']:.1f} ms of device time; "
              f"by wrapper {depth} and {launched}")
        for e in k["by_name"]:
            print(f"  {e['ms']:9.1f} ms {e['count']:7d}x  {e['name']}")
    (k_all, d_all, _), (k_mesh, d_mesh, _), (k_tr, d_tr, _) = (
        counted[x] for x in counted)
    step_glue = (k_mesh["kernels"] - k_tr["kernels"] - d_mesh["sphere_hit"]
                 - d_mesh["shade"] - d_mesh["bounce"]) / n_steps
    sample_glue = (k_tr["kernels"] - d_tr["primary_rays"]) / n_samples
    mesh_ops = k_all["kernels"] - k_mesh["kernels"]
    print(f"depth step headline launches: {k_all['kernels']} in all (the "
          f"parent's {PARENT_LAUNCHES[0]:,}-{PARENT_LAUNCHES[1]:,}); the "
          f"mesh casts {mesh_ops}; the four kernels "
          f"{sum(d_all.values())} ({d_all}); glue {step_glue:.2f} a depth "
          f"step over {n_steps} steps (bound {DEPTH_STEP_GLUE}) and "
          f"{sample_glue:.2f} a sample over {n_samples} samples (bound "
          f"{SAMPLE_GLUE}); on {card}")
    once = {"sphere_hit": 2 * n_steps, "shade": n_steps, "bounce": n_steps,
            "primary_rays": n_samples}
    if d_all != once or step_glue > DEPTH_STEP_GLUE \
            or sample_glue > SAMPLE_GLUE:
        _fail(f"depth step: the glue passes its bound, or the four kernels "
              f"launched {d_all}, not {once} (each once a depth step, the "
              "sphere pass twice, the primary rays once a sample)")

    # d. times on the headline's depth-1 calls (sample 1 for the primary
    # rays): the kernel replayed from a CUDA graph (back to back, so that
    # the L2 may hold its inputs; and with the L2 emptied before each call)
    # and eager, the plain version eager, the bound
    kept, _ = ds.capture(head_frame)
    timing, sphere_calls = {}, {}
    for kernel, kind, label in (("sphere_hit", "closest", "depth 1"),
                                ("sphere_hit", "shadow", "depth 1"),
                                ("shade", "shade", "depth 1"),
                                ("bounce", "bounce", "depth 1"),
                                ("primary_rays", "primary_rays",
                                 "sample 1")):
        args = next(a for lab, kd, a in kept[kernel]
                    if lab == label and kd == kind)
        counts = torch.zeros(6, dtype=torch.int64, device=device)
        kern = lambda: ds.call(kernel, kind, args, False, counts)
        plain = lambda: ds.call(kernel, kind, args, True, counts)
        ms = _time_ms(kern, 50, graph=True)
        cold_ms = _time_ms(kern, 50, graph=True, flush_l2=True)
        eager_ms = _time_ms(kern, 20)
        plain_ms = _time_ms(plain, 3)
        bound, by = ds.call_bound(kernel, kind, args, kern())
        if kind != "shadow":
            timing[kernel] = (ms, plain_ms, bound, by)
        if kernel == "sphere_hit":
            sphere_calls[kind] = args
        lanes = kern()[0].shape[-1]
        print(f"timing {kernel} ({kind}) on the headline's {label} call "
              f"({lanes} lanes): kernel {ms:.4f} ms (graph replay; L2 "
              f"emptied before each call {cold_ms:.4f} ms; eager "
              f"{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}; roofline share {bound / ms:.1%}, L2 "
              f"emptied {bound / cold_ms:.1%}) on {card}")

    # rt_sphere_hit's loop a lane and sphere, from its SASS, and each
    # pipe's time on the depth-1 call
    O, _, stab = sphere_calls["closest"]
    t0 = time.perf_counter()
    try:
        funcs = {_kernels.CSRC: sass.result()}
    except (OSError, subprocess.CalledProcessError, RuntimeError) as e:
        _fail(f"depth step: the library's SASS not read ({e})")
    per = sass_report({_kernels.CSRC: _kernels.BUILD_INFO["library"]}, card,
                      lanes=O.x.shape[0], spheres=stab.radius.shape[0],
                      funcs=funcs)
    print(f"depth step: the library's SASS, read while a-c ran, waited "
          f"for {time.perf_counter() - t0:.2f} s more")
    if len(per) < 2 or not all(
            any(not c["F2F (f32<->f64)"] for c in loops)
            for loops in per.values()):
        _fail(f"depth step: a sphere_hit kernel has no sphere loop free of "
              f"F2F: {per}")

    # e. the headline's and the realtime loop's wall times beside their
    # device time
    for name, fn, rays in (
            ("headline frame", lambda: head_frame(2),
             rays_per_frame(hcfg)),
            (f"realtime loop ({LOOP_FRAMES} frames)", lambda: rt.run_loop(
                rtab, rcfg, LOOP_FRAMES, seed=0, print_every=0),
             rays_per_frame(rcfg) * LOOP_FRAMES)):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        k = device_kernels(fn, top=4)
        wall = sorted(walls)[1]
        print(f"depth step {name}: wall {[round(t, 4) for t in walls]} s "
              f"(median {wall:.4f} s, {rays / wall / 1e6:.3f} Mray/s), "
              f"{k['kernels']} device operations, {k['kernel_ms']:.1f} ms "
              f"of device time (union), busy {k['kernel_ms'] / 1e3 / wall:.3f}"
              f" on {card}")
    return timing, d_all


# Phase 22: a headline frame's device operations before csrc/glue.cu
# (PERF.md: 8,844-8,858), and a pairs cast's then (its mesh casts'
# 7,680 operations over 160 casts)
PARENT_OPS = (8_844, 8_858)
PARENT_CAST_OPS = 48
# a compacted cast's device operations before csrc/cull.cu's compact_bits
# (PERF.md: 20, 14 of them the sort's), and its own beside the sort's now:
# the key, the count's copy to the host, compact_bits, the kernel, the
# scatter
PARENT_COMPACTED_OPS = 20
COMPACTED_OWN_OPS = 5
FULL_CAST_OPS = 3
GLUE_DEPTHS = 3  # the first trace's depths whose glue calls are held
GLUE_SOUP_TIER = 0.875  # a tier that the soup's depth-1 casts fit
SORT_REPS, SORT_PROFILES = 8, 3


def _sort_ops(device_kernels, keys):
    """The device operations of one ``torch.sort(keys)``, counted twice:
    by the tracer and from a CUDA graph.  A trace of a single sort, some
    0.1 ms of work, has come back with one of its 14 operations, so
    SORT_REPS sorts run in each of SORT_PROFILES profiles, after a pause
    that lets the tracer start, and each kernel name counts the most
    launches a sort that any profile saw, rounded up: a trace that misses
    fewer than SORT_REPS launches of a name still counts it right.  The
    graph's nodes (kernels, memsets and copies) need no tracer.  Returns
    (traced, graph nodes)."""
    import torch
    from raytracinggpu_tpu_torch.bench.cull_design import graph_nodes

    def run():
        time.sleep(0.05)
        for _ in range(SORT_REPS):
            torch.sort(keys)
        torch.cuda.synchronize()
        time.sleep(0.05)

    most = {}
    for _ in range(SORT_PROFILES):
        for e in device_kernels(run, top=10**6)["by_name"]:
            most[e["name"]] = max(most.get(e["name"], 0), e["count"])
    traced = sum(-(-c // SORT_REPS) for c in most.values())
    return traced, len(graph_nodes(lambda: torch.sort(keys)))


def _glue_phase(device, card, err, head, rt_scene, pallas_head, soup):
    """Phase 22 (module docstring).  ``head`` phase 4's (config, tables,
    camera, closest casts a frame), ``rt_scene`` phase 7's (config,
    tables), ``pallas_head`` phase 20's (config, tables), ``soup`` phase
    10's (config, tables).  Returns ({kernel: (ms, plain_ms, bound_ms,
    bound_by)}, {kernel: library_ms}, the headline frame's launches of the
    four kernels)."""
    import dataclasses

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.bench import cast_glue as cg
    from raytracinggpu_tpu_torch.bench import depth_step as ds
    from raytracinggpu_tpu_torch.bench.compact_bits_design import (
        library_call)
    from raytracinggpu_tpu_torch.bench.ladder import frames_part
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, rays_per_frame, render_frame, render_preset_frame)
    from raytracinggpu_tpu_torch.scene.presets import build_preset
    from raytracinggpu_tpu_torch.utils.profiling import device_kernels

    hcfg, htab, cam, n_casts = head
    rcfg, rtab = rt_scene
    pcfg, ptab = pallas_head
    scfg, stab = soup
    acfg, atab = build_preset("realtime", device, animate_mesh=True)
    soup_tier = dataclasses.replace(scfg, pairs_compact3=GLUE_SOUP_TIER)
    head_frame = lambda seed=0, cfg=hcfg: render_frame(
        htab, cfg, cam, PRNGKey(seed, device))
    frames = {
        "headline": head_frame,
        "realtime frame 1": lambda: rt.step(
            rtab, rcfg, rt.init_state(rcfg, rtab, seed=0)),
        "animated frame 1": lambda: rt.step(
            atab, acfg, rt.init_state(acfg, atab, seed=0),
            mesh_speed=ANIM_MESH_SPEED),
        "pallas headline": lambda: render_frame(
            ptab, pcfg, cam, PRNGKey(0, device)),
        "soup": lambda: render_preset_frame(stab, scfg, seed=0),
        f"soup, a tier of {GLUE_SOUP_TIER}": lambda: render_preset_frame(
            stab, soup_tier, seed=0),
        "headline, ladder off": lambda: head_frame(0, _ladder_off(hcfg)),
    }

    # a. bitwise on the glue calls of each frame's first trace (depths 0-2
    # and its composite), then on the hard lanes
    outs, tiers, modes, layouts = {}, set(), set(), set()
    for where, fn in frames.items():
        if where == "headline, ladder off":
            continue
        kept, outs[where] = cg.capture(fn, depths=GLUE_DEPTHS)
        torch.cuda.synchronize()
        held = cg.hold(kept, where, err)
        if not all(r[-1] for r in held):
            _fail(f"cast glue {where}: a kernel differs from its plain "
                  "version")
        for label, _, args in kept["compact_bits"]:
            tiers.add((where, args[1]))
            modes.add(int(label.rsplit(" ", 1)[1]))
        layouts |= {kind for _, kind, _ in kept["ray_rows"]}
    print(f"cast glue: compacted casts held at key modes {sorted(modes)}, "
          f"the tiers {sorted(tiers)}; full-width rows in the layouts "
          f"{sorted(layouts)} (live: a cast that overflows every tier)")
    if modes != {1, 2} or layouts != {"pairs", "live", "pallas"}:
        _fail("cast glue: the frames' calls do not cover key modes 1 and 2, "
              "an overflowing cast and every layout")
    for seed in (0, 1):
        if not cg.hold_calls(cg.adversarial_calls(device, seed=seed),
                             f"hard lanes seed {seed}", err):
            _fail("cast glue: a kernel differs from its plain version on "
                  "the hard lanes")

    # b. whole frames, bitwise the frames with the plain glue patched in
    t_eq = lambda a, b: torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
    n_eq = lambda a, b: np.array_equal(a[0], b[0]) and all(
        np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    st_eq = lambda a, b: torch.equal(a[0].accum, b[0].accum) and \
        torch.equal(a[1], b[1])
    outs["headline, ladder off"] = frames["headline, ladder off"]()
    for where, same in (("headline", t_eq), ("realtime frame 1", st_eq),
                        ("animated frame 1", st_eq),
                        ("pallas headline", t_eq), ("soup", n_eq),
                        ("headline, ladder off", t_eq)):
        with cg.plain_glue():
            _kernels.reset_launches()
            plain = frames[where]()
            torch.cuda.synchronize()
            launched = {k: _kernels.LAUNCHES[k]
                        for k in (*_kernels.GLUE, "compact_bits")}
        if any(launched.values()) or not same(outs[where], plain):
            _fail(f"cast glue frames {where}: differs from the frame with "
                  f"the plain glue, or that launched {launched}")
        print(f"cast glue frames {where}: bitwise the frame with the plain "
              "glue patched in (image and TraceStats)")

    # c. a headline frame's device operations: in all, by wrapper, and with
    # its mesh casts replayed (what is left outside them)
    counted = {}
    for label, targets in (("all", ()), ("mesh casts replayed",
                                         ds.MESH_CASTS)):
        record, replay = ds.record_replay(targets)
        with record():
            want = head_frame(1)
        with replay():
            _kernels.reset_launches()
            box = {}
            k = device_kernels(lambda: box.update(out=head_frame(1)),
                               top=40)
            torch.cuda.synchronize()
            cull, depth, glue = {}, {}, {}
            launched = _launched(cull, depth, glue)
            glue["compact_bits"] = cull.pop("compact_bits")
        if not t_eq(box["out"], want):
            _fail(f"cast glue launches ({label}): the replayed frame "
                  "differs")
        counted[label] = (k, glue, {**launched, **cull, **depth})
        print(f"cast glue headline launches ({label}): {k['kernels']} "
              f"device operations, {k['kernel_ms']:.1f} ms of device time; "
              f"by wrapper {glue}, {launched}, {cull}, {depth}")
        for e in k["by_name"]:
            print(f"  {e['ms']:9.1f} ms {e['count']:7d}x  {e['name']}")
    (k_all, g_all, _), (k_mesh, _, _) = counted.values()
    casts, traces = 2 * n_casts, n_casts // hcfg.max_depth
    cast_ops = (k_all["kernels"] - k_mesh["kernels"]) / casts
    print(f"cast glue headline: {k_all['kernels']} device operations (the "
          f"parent's {PARENT_OPS[0]:,}-{PARENT_OPS[1]:,}); a pairs cast "
          f"{cast_ops:.2f} (the parent's {PARENT_CAST_OPS}) over {casts} "
          f"casts; the glue kernels {g_all} ({traces} traces); on {card}")
    if g_all["ray_rows"] + g_all["compact_bits"] != casts \
            or g_all["scatter"] != g_all["compact_bits"] \
            or g_all["composite"] != traces:
        _fail(f"cast glue: launches {g_all}, expected ray_rows + "
              f"compact_bits {casts} (one a pairs cast), scatter = "
              f"compact_bits, composite {traces} (one a trace)")
    if not 2 * k_all["kernels"] < PARENT_OPS[0]:
        _fail(f"cast glue: {k_all['kernels']} device operations, not under "
              f"half of the parent's {PARENT_OPS[0]}")
    # a compacted cast's own device operations, from the frame's mesh
    # casts (a full-width cast makes FULL_CAST_OPS: its rows, culling and
    # kernel), beside the sort's alone on keys of a cast's size
    compacted = g_all["compact_bits"]
    per_compacted = (cast_ops * casts - FULL_CAST_OPS * g_all["ray_rows"]) \
        / max(compacted, 1)
    keys = torch.randint(0, 2**30, (512 * 1024,), dtype=torch.int32,
                         device=device)
    sort_traced, sort_nodes = _sort_ops(device_kernels, keys)
    sort_ops = max(sort_traced, sort_nodes)
    print(f"cast glue: a compacted cast makes {per_compacted:.2f} device "
          f"operations ({compacted} compacted and {g_all['ray_rows']} "
          f"full-width casts; the parent's {PARENT_COMPACTED_OPS}): the "
          f"sort's {sort_ops} (traced {sort_traced}, graph nodes "
          f"{sort_nodes}) and {COMPACTED_OWN_OPS} more (the key, the "
          f"count's copy to the host, compact_bits, the kernel, the "
          f"scatter); on {card}")
    if not compacted or abs(per_compacted - sort_ops - COMPACTED_OWN_OPS) \
            > 0.25:
        _fail(f"cast glue: a compacted cast makes {per_compacted:.2f} "
              f"device operations, not the sort's {sort_ops} + "
              f"{COMPACTED_OWN_OPS}")

    # d. times on the headline's casts (the depth-0 rows, the depth-1
    # compacted casts, the first trace's composite): replayed from a CUDA
    # graph (back to back; and with the L2 emptied before each call) and
    # eager, the plain version eager, the bound; the gather's PyTorch call
    kept, _ = cg.capture(head_frame, depths=2)
    first = lambda kernel, start: next(
        (lab, a) for lab, _, a in kept[kernel] if lab.startswith(start))
    closest1 = first("compact_bits", "trace 0 depth 1 closest")[1]
    cases = [("ray_rows", *first("ray_rows", "trace 0 depth 0 closest")),
             # the depth-1 casts' rays at full width: what a cast that
             # overflows every tier builds
             ("ray_rows", "trace 0 depth 1 closest, at full width (live)",
              (*closest1[3:5], *closest1[8:10], "live")),
             ("compact_bits", *first("compact_bits",
                                     "trace 0 depth 1 closest")),
             ("compact_bits", *first("compact_bits",
                                     "trace 0 depth 1 shadow")),
             ("scatter", *first("scatter", "trace 0 depth 1 closest")),
             ("scatter", *first("scatter", "trace 0 depth 1 shadow")),
             ("composite", *first("composite", "trace 0"))]
    timing, library = {}, {}
    for kernel, label, args in cases:
        kern = lambda: cg.call(kernel, args, False)
        plain = lambda: cg.call(kernel, args, True)
        ms = _time_ms(kern, 50, graph=True)
        cold_ms = _time_ms(kern, 50, graph=True, flush_l2=True)
        eager_ms = _time_ms(kern, 20)
        plain_ms = _time_ms(plain, 3)
        bound, by = cg.call_bound(kernel, args, kern())
        line = ""
        if kernel == "compact_bits":
            lib_ms = _time_ms(library_call(args), 50, graph=True)
            library.setdefault(kernel, lib_ms)
            line = (f", torch.index_select of the live rows + rt_pair_bits "
                    f"{lib_ms:.4f} ms")
        timing.setdefault(kernel, (ms, plain_ms, bound, by))
        print(f"timing {kernel} on the headline's {label} "
              f"({cg.lanes(kernel, args)} lanes): kernel {ms:.4f} ms (graph "
              f"replay; L2 emptied before each call {cold_ms:.4f} ms; eager "
              f"{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}; roofline share {bound / ms:.1%}, L2 "
              f"emptied {bound / cold_ms:.1%}){line} on {card}")

    # e. the walls beside their device time and busy share, and the
    # ladder on / off (bench/ladder.py's frames part, 3 frames each way)
    for name, fn, rays in (
            ("headline frame", lambda: head_frame(2), rays_per_frame(hcfg)),
            ("pallas headline frame", frames["pallas headline"],
             rays_per_frame(pcfg)),
            ("soup frame", frames["soup"], rays_per_frame(scfg)),
            (f"realtime loop ({LOOP_FRAMES} frames)", lambda: rt.run_loop(
                rtab, rcfg, LOOP_FRAMES, seed=0, print_every=0),
             rays_per_frame(rcfg) * LOOP_FRAMES)):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        k = device_kernels(fn, top=4)
        wall = sorted(walls)[1]
        print(f"cast glue {name}: wall {[round(t, 4) for t in walls]} s "
              f"(median {wall:.4f} s, {rays / wall / 1e6:.3f} Mray/s), "
              f"{k['kernels']} device operations, {k['kernel_ms']:.1f} ms "
              f"of device time (union), busy {k['kernel_ms'] / 1e3 / wall:.3f}"
              f" on {card}")
    ladder = lambda cfg, tab: (cfg, tab, lambda c, seed: render_frame(
        tab, c, Camera.default(c, device), PRNGKey(seed, device)))
    frames_part({"headline": ladder(hcfg, htab), "soup": ladder(scfg, stab)},
                3, card)
    return timing, library, g_all


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    _adopt_orphans()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, chunk_size, group_size, rays_per_frame, render_frame)
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    lap = _Laps()

    # ---- 1. environment --------------------------------------------------
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, torch CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {count}")
    lap("1 environment")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.load()
    info = _kernels.BUILD_INFO
    build_s = time.perf_counter() - t0
    print(f"nvcc: {info['nvcc']} ({info['nvcc_version']})")
    print(f"build: {'compiled' if info['compiled'] else 'cached'} "
          f"{os.path.relpath(info['library'])} in {info['seconds']:.2f} s "
          f"(build+load {build_s:.2f} s)")
    entry = "?"
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            # the template argument tells the specializations apart
            entry = next((k for m, k in _MODES.items() if m in line), "?")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {entry}: {line.strip()}")
    lap("2 build")

    # ---- 3. per-cast check -----------------------------------------------
    t0 = time.perf_counter()
    cfg, tables = build_preset("array_bvh", device, width=512, height=512,
                               spp=32, max_depth=5)
    torch.cuda.synchronize()
    print(f"scene: array_bvh {cfg.width}x{cfg.height} spp {cfg.spp} depth "
          f"{cfg.max_depth}, {tables.pairs_mesh.tile_aabb.shape[0]} tiles, "
          f"subgroup {cfg.pairs_subgroup}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    tab = tables.pairs_mesh
    cam = Camera.default(cfg, device)
    g = group_size(cfg, cfg.spp)
    R_group = g * cfg.width * cfg.height
    chunk = chunk_size(cfg, R_group)
    n_casts = (cfg.spp // g) * cfg.max_depth * -(-R_group // chunk)
    # The integrator launches each kernel once per depth, so the first two
    # launches of each are the depth-0 and depth-1 casts of the frame's
    # first wavefront (samples 0..g-1) and its first chunk of `chunk` rays.
    # The capture frame runs with the compaction ladder off, so that its
    # casts are whole (phase 18 keeps the compacted ones), and phase 4's
    # default frame must equal it.
    t0 = time.perf_counter()
    _kernels.reset_launches()
    kept, (cap_img, cap_stats) = _capture_casts(
        lambda: render_frame(tables, _ladder_off(cfg), cam,
                             PRNGKey(0, device)), 2)
    torch.cuda.synchronize()
    cap_launches = _launched()
    print(f"capture frame (ladder off): {time.perf_counter() - t0:.3f} s; "
          f"casts of {chunk} rays ({g} samples per wavefront), launches "
          f"{cap_launches}")
    err = {k: 0.0 for k in _kernels.LAUNCHES}
    casts = _check_casts(kept, {"pairs_closest": ("pairs_closest_idx",),
                                "pairs_shadow": ()},
                         tab, cfg, err, "array_bvh")
    lap("3 per-cast check")

    # ---- 4. headline frame -----------------------------------------------
    _kernels.reset_launches()
    t0 = time.perf_counter()
    img, stats = render_frame(tables, cfg, cam, PRNGKey(0, device))
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    culling, depth = {}, {}
    launches = _launched(culling, depth)
    n_rays = cfg.width * cfg.height * cfg.spp
    hit = stats.hit.tolist()
    # every cast culls once; the ladder keys each cast at depth >= 1
    keyed = n_casts * (cfg.max_depth - 1) // cfg.max_depth
    print(f"headline frame: {counted_s:.3f} s, launches {launches} "
          f"(expected {n_casts} each) and of the culling {culling} "
          f"(expected pair_bits + compact_bits {2 * n_casts}, compact_key "
          f"{2 * keyed}), "
          f"hit per depth {hit}, shadowed "
          f"{stats.shadowed.tolist()}, image mean {float(img.mean()):.3f}")
    if not bool(torch.isfinite(img).all()):
        _fail("headline image has non-finite values")
    if not torch.equal(img, cap_img) or any(
            not torch.equal(a, b) for a, b in zip(stats, cap_stats)):
        _fail("the same seed gave another frame or other TraceStats than "
              "the capture frame (the ladder off)")
    if any(h != n_rays for h in hit):
        _fail(f"rays escaped the enclosed scene: hit {hit} != {n_rays}")
    if int(stats.shadowed.sum()) <= 0:
        _fail("no shadow ray was occluded")
    expected = _none()
    expected.update(pairs_closest=n_casts, pairs_shadow=n_casts)
    if launches != expected or cap_launches != expected:
        _fail(f"launches in the frame {launches}, with the ladder off "
              f"{cap_launches}, expected {expected}")
    if culling["pair_bits"] + culling["compact_bits"] != 2 * n_casts \
            or culling["compact_key"] != 2 * keyed or culling["tile_lists"]:
        _fail(f"culling launches in the frame {culling}, expected "
              f"pair_bits + compact_bits {2 * n_casts}, compact_key "
              f"{2 * keyed} and tile_lists 0")
    # a depth step is one closest and one shadow cast
    once = {"sphere_hit": 2 * n_casts, "shade": n_casts, "bounce": n_casts,
            "primary_rays": cfg.spp}
    if depth != once:
        _fail(f"depth-step launches in the frame {depth}, expected {once}")
    print("headline frame (the ladder on, the default) bitwise the capture "
          "frame (the ladder off), TraceStats equal")
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_frame(tables, cfg, cam, PRNGKey(i + 1, device))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    mrays = rays_per_frame(cfg) / min(times) / 1e6
    head_img, head_stats, rays0 = img, stats, kept["pairs_closest"][0][0]
    print(f"headline: {mrays:.3f} Mray/s (array_bvh 512x512 spp32 d5 pairs, "
          f"{rays_per_frame(cfg)} rays/frame, frame times "
          f"{[round(t, 4) for t in times]} s) on {card}")
    lap("4 headline frame")

    # ---- 5. kernel timings -----------------------------------------------
    # every captured cast is timed; the JSON line reports the depth-1 ones
    # (B1 and B2 here, B3 and B0 on the realtime casts of phase 7)
    timing_main = {}
    _time_casts(casts, timing_main, card)
    lap("5 kernel timings")

    # ---- 6. production anchor --------------------------------------------
    import dataclasses

    acfg = dataclasses.replace(cfg, spp=8, max_depth=3)
    img, _ = render_frame(tables, acfg, cam, PRNGKey(0, device))
    mean = float(img.double().mean())
    rel = (mean - ANCHOR_CPU_MEAN) / ANCHOR_CPU_MEAN
    print(f"anchor: 512x512 spp8 d3 seed 0 image mean {mean:.3f} vs the JAX "
          f"package on CPU {ANCHOR_CPU_MEAN:.3f} (rel {rel:+.6f}, limit "
          f"{ANCHOR_RTOL}); its TPU record {ANCHOR_TPU_MEAN} (rel "
          f"{(mean - ANCHOR_TPU_MEAN) / ANCHOR_TPU_MEAN:+.5f})")
    if not abs(rel) <= ANCHOR_RTOL:
        _fail(f"anchor mean {mean} off by {rel:.4%}")
    lap("6 production anchor")

    # ---- 7. realtime loop ------------------------------------------------
    timing_rt = {}
    loop_launches, loop_ms, (rcfg, rtab, rcasts) = _realtime(
        device, card, err, timing_rt)
    lap("7 realtime loop")

    # ---- 8. mesh query ---------------------------------------------------
    query_launches = _mesh_query(rcfg, rtab, rcasts, err)
    lap("8 mesh query")

    # ---- 9. the tiled-kernel traversal -----------------------------------
    timing_pallas = {}
    pallas_launches, pallas_anchor = _pallas(device, card, err,
                                             timing_pallas, mrays)
    lap("9 tiled traversal")

    # ---- 10. the big-mesh path -------------------------------------------
    err_b4 = {k: 0.0 for k in _kernels.LAUNCHES}
    soup_launches, b4, soup = _big_mesh(device, card, err_b4)
    lap("10 big-mesh path")
    # B4 is B1 and B2 past ST_SLOTS: its launches are theirs in the soup
    # frame, its error the largest of B0-B3's there, its times the sums of
    # B1's and B2's on the busiest windows of the depth-1 casts
    err["pairs_b4"] = max(err_b4.values())
    timing_b4 = {"pairs_b4": b4}
    soup_launches["pairs_b4"] = (soup_launches["pairs_closest"]
                                 + soup_launches["pairs_shadow"])

    # ---- 11. the probes --------------------------------------------------
    probe_launches, timing_probes, library = _probes(device, card, err)
    lap("11 probes")

    # ---- 12. the sweep and the last presets ------------------------------
    _sweep_and_presets(device, card, mrays)
    lap("12 sweep and presets")

    # ---- 13. the animated mesh, the bvh walk, the clusterings -------------
    _animated_loop(device, card, err, loop_ms)
    lap("13a animated loop")
    _animated_anchor(device)
    lap("13b animated anchor")
    _posed_vs_host(device)
    lap("13c posed vs host rebuild")
    _bvh_walk(device, card, rays0)
    lap("13d bvh")
    _clustering(device, card, head_img)
    lap("13e clustering")

    # ---- 14. multi-rank rendering ----------------------------------------
    _sharded(device, card, count, head_img, head_stats, pallas_anchor)
    lap("14 multi-rank")

    # ---- 15. the numpy oracle on the card --------------------------------
    _oracle(device, card)
    lap("15 oracle")

    # ---- 16. the native host runtime --------------------------------------
    _native_phase(device, card, head_img)
    lap("16 native")

    # ---- 17. the gallery -------------------------------------------------
    _gallery(card)
    lap("17 gallery")

    # ---- 18. the compaction ladder ----------------------------------------
    _ladder_phase(device, card, err, (cfg, tables, cam), (rcfg, rtab), soup)
    lap("18 compaction ladder")

    # ---- 19. the culling kernels ------------------------------------------
    timing_cull = _culling_phase(device, card, err, (cfg, tables, cam),
                                 (head_img, head_stats), (rcfg, rtab), soup)
    lap("19 culling kernels")

    # ---- 20. the tiled culling kernel --------------------------------------
    timing_tiles, _, pallas_head = _tile_culling_phase(device, card, err,
                                                       soup)
    lap("20 tiled culling kernel")

    # ---- 21. the depth step's kernels --------------------------------------
    timing_depth, depth_launches = _depth_step_phase(
        device, card, err, (cfg, tables, cam, n_casts), (rcfg, rtab),
        pallas_head, soup)
    lap("21 depth-step kernels")

    # ---- 22. the mesh casts' glue and the composite ------------------------
    timing_glue, library_glue, glue_launches = _glue_phase(
        device, card, err, (cfg, tables, cam, n_casts), (rcfg, rtab),
        pallas_head, soup)
    library.update(library_glue)
    lap("22 cast glue kernels")

    # no single PyTorch call computes a masked Moller-Trumbore closest hit
    # or nearest t, so library_ms is null for every kernel but B7b (2 x:
    # torch.mul), the row gather (torch.index_select) and compact_bits
    # (torch.index_select of the live rows, then rt_pair_bits)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": _ORIGIN[k][0],
         "replaces": _ORIGIN[k][1], "launches": counts[k],
         "max_abs_err": err[k], "ms": timing[k][0], "plain_ms": timing[k][1],
         "bound_ms": timing[k][2], "bound_by": timing[k][3],
         "library_ms": library.get(k)}
        for k, counts, timing in (
            ("pairs_closest", launches, timing_main),
            ("pairs_shadow", launches, timing_main),
            ("pairs_closest_smooth", loop_launches, timing_rt),
            ("pairs_closest_idx", query_launches, timing_rt),
            ("pallas_closest", pallas_launches, timing_pallas),
            ("pallas_shadow", pallas_launches, timing_pallas),
            ("pairs_b4", soup_launches, timing_b4),
            ("pair_bits", culling, timing_cull),
            ("compact_key", culling, timing_cull),
            ("tile_lists", pallas_launches, timing_tiles),
            ("compact_bits", culling, timing_glue),
            *((k, probe_launches, timing_probes) for k in _PROBE_ROW),
            *((k, depth_launches, timing_depth)
              for k in _kernels.DEPTH_STEP),
            *((k, glue_launches, timing_glue) for k in _kernels.GLUE))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if sys.platform == "linux":
            _stop_leftovers()
    sys.exit(rc)
