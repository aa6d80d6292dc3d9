"""The plain reference against the program's CPU path on a small frame,
its grouped mesh query against the all-triangles one, and its frozen RNG
against the program's; and the import guard: nothing the benchmark runs
loads ``jax`` or ``raytracinggpu_tpu`` (whole top-level names), and the
reference loads nothing of ``raytracinggpu_tpu_torch``."""
from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import check, meshes, reference, spec

HERE = spec.HERE
W, SPP, D = 32, 4, 3
# The two round alike, so they agree but where a path is rounded onto
# another branch (a grazing triangle edge, which classic Moller-Trumbore
# and the program's feature rows decide apart): few pixels off, the
# frame's sum within those paths
OFF_TOL, MEAN_TOL = 1e-2, 1e-3


def config(name):
    return spec.load_cell(
        {"array_bvh": "array_bvh.spp32_d5",
         "realtime": "realtime.loop_spp20_d3"}[name]).config


@pytest.mark.parametrize("name", ["array_bvh", "realtime"])
def test_reference_matches_program_cpu_frame(name):
    from raytracinggpu_tpu_torch import Renderer
    from raytracinggpu_tpu_torch.render import realtime as rt

    cfg = config(name)
    seed = 2**31 + 77
    r = Renderer(cfg["program"]["preset"], device="cpu", width=W, height=W,
                 spp=SPP, max_depth=D)
    L0 = np.asarray(cfg["scene"]["light"], np.float32)
    key = reference.seed_key(seed, "cpu")
    if name == "realtime":
        st = rt.init_state(r.cfg, r.scene, seed)
        st, _ = rt.step(r.scene, r.cfg, st, 1.0, 0.02)
        st, _ = rt.step(r.scene, r.cfg, st, 1.0, 0.02)
        st2, _ = rt.step(r.scene, r.cfg, st, 1.0, 0.02)
        prog = (st2.accum - st.accum).numpy()
        key = reference.fold_in(key, 2)
        L = reference.orbit_light(L0, 2, 1.0, 0.02)
    else:
        prog, _ = r.render_hdr(seed=seed)
        L = L0
    sc = reference.build_scene(cfg["scene"], meshes.resolve(cfg).path, "cpu")
    view = dict(cfg["view"], width=W, height=W)
    ref = reference.render_rows(sc, view, key, np.arange(W), SPP, D,
                                L).numpy()
    nums = check.frame_numbers(prog, ref)
    assert nums["px_off_share"] < OFF_TOL
    assert nums["mean_gap"] < MEAN_TOL


def test_reference_rng_is_the_programs():
    from raytracinggpu_tpu_torch.core import rng

    rows = torch.arange(5)
    for seed in (0, 7, 2**31 + 5, 2**40 + 3):
        k = rng.fold_in(rng.PRNGKey(seed, "cpu"), 3)
        want = rng.row_uniforms(k, rows, 16, 2).reshape(3, 2, 5, 16)
        rk = reference.fold_in(reference.seed_key(seed, "cpu"), 3)
        got = reference.row_uniforms(rk, rows, 16, 2)
        assert torch.equal(got, want)


def test_grouped_mesh_query_is_the_brute_force_one():
    cfg = config("array_bvh")
    sc = reference.build_scene(cfg["scene"], meshes.resolve(cfg).path, "cpu")
    g = torch.Generator().manual_seed(11)
    R = 2000
    O = torch.randn(3, R, generator=g) * 8
    O[1] -= 10
    tgt = torch.randn(3, R, generator=g) * 4 + torch.tensor([0, -8, 0])[:, None]
    u = torch.nn.functional.normalize(tgt - O, dim=0)
    t, n = reference.intersect_mesh(sc, O, u, normal=True)
    T = sc.n_tri
    all_ids = torch.arange(T).expand(R, T)
    tb, _, _ = reference._mt(sc, O, u, all_ids)
    tmin, j = torch.min(tb, 1)
    assert (t < reference.INF).sum() > 100
    assert torch.equal(t, tmin)
    hit = tmin < reference.INF
    A, B, C = (v[j] for v in sc.tris)
    ng = torch.cross(B - A, C - A, dim=-1).T
    assert torch.equal(n[:, hit], ng[:, hit])


FORBIDDEN = ("jax", "jaxlib", "flax", "raytracinggpu_tpu")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_package():
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_and_check_import_nothing_of_the_program():
    for mod in ("reference", "check", "frozen"):
        names = set(_imports(os.path.join(HERE, f"{mod}.py")))
        assert not {n for n in names
                    if n.split(".")[0] == "raytracinggpu_tpu_torch"}, mod


def test_a_run_loads_no_jax_package():
    """A whole run on the CPU, then every loaded module by whole
    top-level name: the program's name begins with the JAX package's, so a
    prefix test would be wrong."""
    code = (
        "import sys, time, json\n"
        "from benchmark import run, spec\n"
        "cell = spec.load_cell('realtime.loop_spp20_d3')\n"
        "cell.traffic = dict(cell.traffic, spp=1, max_depth=1)\n"
        "run.execute(cell, 5, 0.2, True, device='cpu',\n"
        "            settings={'width': 16, 'height': 16},\n"
        "            t_start=time.perf_counter())\n"
        "import benchmark.calibrate\n"
        "print(json.dumps([run.forbidden_modules(),\n"
        "  'raytracinggpu_tpu_torch' in sys.modules]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    bad, loaded = json.loads(p.stdout.strip().splitlines()[-1])
    assert bad == [] and loaded


def test_forbidden_names_are_whole_top_level_names():
    from benchmark import run

    try:
        sys.modules["raytracinggpu_tpu_torch_x"] = sys
        assert "raytracinggpu_tpu_torch_x" not in run.forbidden_modules()
        sys.modules["raytracinggpu_tpu.api"] = sys
        assert "raytracinggpu_tpu.api" in run.forbidden_modules()
    finally:
        sys.modules.pop("raytracinggpu_tpu_torch_x", None)
        sys.modules.pop("raytracinggpu_tpu.api", None)
