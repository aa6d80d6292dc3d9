"""The port's native host runtime (raytracinggpu_tpu_torch/native.py)
against its numpy paths, bit for bit: the OBJ parser (the cat, a
160-corner polygon, the embedded transform, the soup), the BVH builder
(also against the JAX package's numpy builder) and the PNG writer; and the
``native=`` semantics: True raises with the compiler's message when the
build fails, None falls back to numpy with one warning naming why.

The library is built here with g++ from native/src/rt_native.cpp; the
tests skip only where g++ or zlib.h is missing.
"""
import os
import shutil
import warnings

import numpy as np
import pytest

from raytracinggpu_tpu.accel.bvh import build_bvh as j_build_bvh
from raytracinggpu_tpu_torch import native
from raytracinggpu_tpu_torch.accel.bvh import build_bvh, check_invariants
from raytracinggpu_tpu_torch.bench.big_mesh import soup_obj
from raytracinggpu_tpu_torch.render.image_io import read_png, write_png
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH, read_obj

OBJ_FIELDS = ("vertices", "normals", "uvs", "vtx", "nrm", "uv")
BVH_FIELDS = ("left", "right", "mn", "mx", "tri_start", "tri_end", "skip",
              "order")


@pytest.fixture(scope="module", autouse=True)
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    try:
        return native.load()
    except RuntimeError as e:
        if "zlib.h" in str(e):
            pytest.skip("zlib.h not found")
        raise


def _same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                      err_msg=f)


def _corners(obj):
    V = obj.vertices
    return tuple(V[obj.vtx[:, k]] for k in range(3))


def test_library_is_built_into_the_package():
    path = native.BUILD_INFO["library"]
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("rt_native_")
    assert os.path.isfile(path) and "librt_native" not in path
    assert native.resolve(True) is native.load()
    assert native.resolve(None) is native.load()
    assert native.resolve(False) is None


@pytest.mark.parametrize("embed", [False, True])
def test_obj_parse_matches_numpy(embed):
    py = read_obj(CAT_OBJ_PATH, embed_transform=embed, native=False)
    nat = read_obj(CAT_OBJ_PATH, embed_transform=embed, native=True)
    _same(nat, py, OBJ_FIELDS + ("group",))  # the cat: one usemtl, first
    assert py.vtx.shape == (3954, 3)


def test_obj_parse_long_polygon_face(tmp_path):
    """A 160-corner polygon whose face line exceeds 1024 bytes: the native
    parser fan-triangulates every corner across split reads."""
    n = 160
    lines = []
    for k in range(n):
        a = 2 * np.pi * k / n
        lines.append(f"v {np.cos(a):.9f} {np.sin(a):.9f} 0.000000000")
        lines.append(f"vt {k / n:.9f} {k / n:.9f}")
        lines.append("vn 0.000000000 0.000000000 1.000000000")
    lines.append(
        "f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in range(n)))
    p = tmp_path / "poly.obj"
    p.write_text("\n".join(lines) + "\n")
    assert len(lines[-1]) > 1024
    py = read_obj(str(p), native=False)
    nat = read_obj(str(p), native=True)
    assert py.vtx.shape == (n - 2, 3)
    _same(nat, py, OBJ_FIELDS)


def test_soup_parse_and_bvh_match_numpy(tmp_path):
    p = str(tmp_path / "soup.obj")
    soup_obj(p, 3000)
    py, nat = read_obj(p, native=False), read_obj(p, native=True)
    _same(nat, py, OBJ_FIELDS)
    A, B, C = _corners(py)
    _same(build_bvh(A, B, C, native=True), build_bvh(A, B, C, native=False),
          BVH_FIELDS)


def test_bvh_build_bit_equal():
    A, B, C = _corners(read_obj(CAT_OBJ_PATH, native=False))
    py = build_bvh(A, B, C, native=False)
    nat = build_bvh(A, B, C, native=True)
    _same(nat, py, BVH_FIELDS)
    check_invariants(nat, A, B, C)


def test_bvh_native_matches_the_jax_numpy_builder():
    A, B, C = _corners(read_obj(CAT_OBJ_PATH, native=False))
    _same(build_bvh(A, B, C, native=True), j_build_bvh(A, B, C, native=False),
          BVH_FIELDS)


def test_png_roundtrip(tmp_path):
    rgb = (np.random.default_rng(5).random((16, 24, 3)) * 255).astype(np.uint8)
    a, b = str(tmp_path / "n.png"), str(tmp_path / "p.png")
    write_png(a, rgb, native=True)
    write_png(b, rgb, native=False)
    np.testing.assert_array_equal(read_png(a), rgb)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()  # the same zlib stream


@pytest.fixture()
def broken(tmp_path, monkeypatch):
    """A source the compiler refuses, built into an empty directory by a
    module that has loaded nothing yet."""
    src = tmp_path / "rt_native.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_warned", False)
    monkeypatch.delenv("RT_NATIVE", raising=False)


def test_native_true_raises_with_the_compilers_message(broken):
    A, B, C = _corners(read_obj(CAT_OBJ_PATH, native=False))
    for call in (lambda: read_obj(CAT_OBJ_PATH, native=True),
                 lambda: build_bvh(A, B, C, native=True)):
        with pytest.raises(RuntimeError, match="error"):
            call()
    assert "rt_native.cpp" in native._error and "error" in native._error


def test_native_none_falls_back_with_one_warning(broken, tmp_path):
    with pytest.warns(UserWarning, match="(?s)native host runtime off.*error"):
        py = read_obj(CAT_OBJ_PATH)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once a process
        A, B, C = _corners(py)
        bvh = build_bvh(A, B, C)
        write_png(str(tmp_path / "x.png"), np.zeros((2, 2, 3), np.uint8))
    _same(py, read_obj(CAT_OBJ_PATH, native=False), OBJ_FIELDS)
    _same(bvh, build_bvh(A, B, C, native=False), BVH_FIELDS)


def test_rt_native_0_takes_numpy_with_a_warning(monkeypatch):
    monkeypatch.setenv("RT_NATIVE", "0")
    monkeypatch.setattr(native, "_warned", False)
    with pytest.warns(UserWarning, match="RT_NATIVE=0"):
        assert native.resolve(None) is None
    assert native.resolve(True) is native.load()
