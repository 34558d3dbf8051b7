"""Native C++ loader: parity with the Python OBJ path + speed sanity."""

import os
import time

import numpy as np
import pytest

from trident.assets.model_loader import load_obj
from trident.assets.native import get_lib, load_obj_native


def write_obj(tmp_path, quads=200):
    """A grid of textured quads with two materials."""
    lines = ["mtllib grid.mtl"]
    (tmp_path / "grid.mtl").write_text(
        "newmtl a\nKd 0.9 0.2 0.1\nNs 16\nmap_Kd tex.png\n"
        "newmtl b\nKd 0.1 0.2 0.9\nPm 0.25\nPr 0.4\n")
    n = int(np.sqrt(quads))
    for i in range(n):
        for j in range(n):
            x, y = i * 1.0, j * 1.0
            lines += [f"v {x} {y} 0", f"v {x+0.9} {y} 0",
                      f"v {x+0.9} {y+0.9} 0", f"v {x} {y+0.9} 0"]
            lines += [f"vt 0 0", f"vt 1 0", f"vt 1 1", f"vt 0 1"]
    lines.append("usemtl a")
    half = (n * n) // 2
    for q in range(half):
        b = q * 4 + 1
        lines.append(f"f {b}/{b} {b+1}/{b+1} {b+2}/{b+2} {b+3}/{b+3}")
    lines.append("usemtl b")
    for q in range(half, n * n):
        b = q * 4 + 1
        lines.append(f"f {b}/{b} {b+1}/{b+1} {b+2}/{b+2} {b+3}/{b+3}")
    path = tmp_path / "grid.obj"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture
def native_lib():
    lib = get_lib()
    if lib is None:
        pytest.skip("native loader unavailable (no g++?)")
    return lib


def test_native_matches_python(tmp_path, native_lib):
    path = write_obj(tmp_path)
    py = load_obj(path)
    nat = load_obj_native(path)
    assert nat is not None
    assert len(nat.meshes) == len(py.meshes)
    assert len(nat.materials) == len(py.materials)
    for pm, nm in zip(py.materials, nat.materials):
        np.testing.assert_allclose(pm.base_color, nm.base_color, atol=1e-6)
        assert pm.metallic == pytest.approx(nm.metallic, abs=1e-6)
        assert pm.roughness == pytest.approx(nm.roughness, abs=1e-6)
    for pmesh, nmesh in zip(py.meshes, nat.meshes):
        assert pmesh.vertex_count == nmesh.vertex_count
        assert pmesh.triangle_count == nmesh.triangle_count
        assert pmesh.material_index == nmesh.material_index
        # same triangles (Morton order must agree: same algorithm)
        ptri = pmesh.positions[pmesh.indices.reshape(-1, 3)]
        ntri = nmesh.positions[nmesh.indices.reshape(-1, 3)]
        np.testing.assert_allclose(ptri, ntri, atol=1e-6)
        np.testing.assert_allclose(
            pmesh.uvs[pmesh.indices], nmesh.uvs[nmesh.indices], atol=1e-6)
        np.testing.assert_allclose(
            pmesh.normals[pmesh.indices], nmesh.normals[nmesh.indices], atol=1e-4)
        np.testing.assert_allclose(
            pmesh.tangents[pmesh.indices], nmesh.tangents[nmesh.indices], atol=1e-3)
    # texture reference survived
    assert nat.materials[0].base_color_texture >= 0
    assert nat.textures[0].path.endswith("tex.png")


def test_native_negative_indices(tmp_path, native_lib):
    (tmp_path / "neg.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    nat = load_obj_native(str(tmp_path / "neg.obj"))
    assert nat is not None and nat.meshes[0].triangle_count == 1


def test_native_faster_than_python(tmp_path, native_lib):
    path = write_obj(tmp_path, quads=2500)
    t0 = time.perf_counter()
    load_obj(path)
    py_time = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_obj_native(path)
    native_time = time.perf_counter() - t0
    # informational bound: native shouldn't be slower
    assert native_time < py_time * 1.5
