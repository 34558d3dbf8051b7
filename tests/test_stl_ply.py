"""STL + PLY loaders (assets/stl_ply_loader.py).

The reference accepts both through Assimp (ModelLoader.cpp:27-38); these
parsers must produce the same ModelData contract as the other loaders."""

import struct

import numpy as np

from trident.assets.model_loader import load_model

QUAD = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0],
                 [0, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)


def _write_binary_stl(path, tris, normals=None):
    t = tris.reshape(-1, 3, 3)
    with open(path, "wb") as f:
        f.write(b"solid-binary-trap".ljust(80, b"\0"))   # evil prefix
        f.write(struct.pack("<I", t.shape[0]))
        for k in range(t.shape[0]):
            n = normals[k] if normals is not None else [0, 0, 0]
            f.write(struct.pack("<3f", *n))
            for v in t[k]:
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))


def test_binary_stl_with_solid_prefix(tmp_path):
    p = str(tmp_path / "quad.stl")
    _write_binary_stl(p, QUAD)
    data = load_model(p)
    mesh = data.meshes[0]
    assert mesh.triangle_count == 2
    assert mesh.vertex_count == 6
    # zero facet normals were recomputed from winding (+z here)
    assert np.allclose(np.abs(mesh.normals[:, 2]), 1.0)
    assert len(data.materials) == 1


def test_ascii_stl(tmp_path):
    p = tmp_path / "tri.stl"
    p.write_text(
        "solid tri\n"
        " facet normal 0 0 1\n"
        "  outer loop\n"
        "   vertex 0 0 0\n   vertex 1 0 0\n   vertex 0 1 0\n"
        "  endloop\n"
        " endfacet\n"
        "endsolid tri\n")
    mesh = load_model(str(p)).meshes[0]
    assert mesh.triangle_count == 1
    assert np.allclose(mesh.positions[mesh.indices[1]], [1, 0, 0])


def test_ascii_ply_colors_and_quads(tmp_path):
    p = tmp_path / "quad.ply"
    p.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "element face 1\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0 255 0 0\n1 0 0 0 255 0\n1 1 0 0 0 255\n0 1 0 255 255 255\n"
        "4 0 1 2 3\n")
    mesh = load_model(str(p)).meshes[0]
    assert mesh.triangle_count == 2            # quad fan-triangulated
    assert mesh.vertex_count == 4
    assert np.allclose(sorted(mesh.colors[:, 0]), [0, 0, 1, 1])
    # missing normals → smooth normals, all +z for a flat quad
    assert np.allclose(np.abs(mesh.normals[:, 2]), 1.0, atol=1e-5)


def test_binary_ply(tmp_path):
    p = tmp_path / "tri.ply"
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        "element vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "element face 1\n"
        "property list uchar int vertex_indices\n"
        "end_header\n").encode()
    body = b""
    for v in ([0, 0, 0], [2, 0, 0], [0, 2, 0]):
        body += struct.pack("<6f", *v, 0, 0, 1)
    body += struct.pack("<B3i", 3, 0, 1, 2)
    p.write_bytes(header + body)
    mesh = load_model(str(p)).meshes[0]
    assert mesh.triangle_count == 1
    assert np.allclose(mesh.positions.max(), 2.0)
    assert np.allclose(mesh.normals[:, 2], 1.0)


def test_stl_renders_end_to_end(tmp_path):
    from trident.assets.scene_loader import import_model_entities
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.registry import Registry
    from trident.render.renderer import Renderer

    p = str(tmp_path / "quad.stl")
    _write_binary_stl(p, QUAD - 0.5)
    r = Renderer(EngineConfig(render=RenderConfig(width=48, height=48,
                                                  use_pallas=False)))
    reg = Registry()
    r.set_active_registry(reg)
    ents = import_model_entities(p, reg, r)
    assert len(ents) == 1
    r.editor_camera.set_position([0, 0, 2])
    r.editor_camera.look_at_target([0, 0, 0])
    img = np.asarray(r.read_frame())
    assert img[24, 24, :3].astype(int).sum() > 30   # quad visible at center


def test_binary_stl_with_trailing_bytes(tmp_path):
    """Several common exporters append bytes after the last record; the
    Assimp-backed reference loads them (advisor round-4 finding)."""
    p = str(tmp_path / "trail.stl")
    _write_binary_stl(p, QUAD)
    with open(p, "ab") as f:
        f.write(b"\0" * 37 + b"exporter junk")
    mesh = load_model(p).meshes[0]
    assert mesh.triangle_count == 2


def test_ply_color_scale_follows_declared_dtype(tmp_path):
    """uchar colors divide by 255 even when every observed value <= 1
    (near-black mesh); float colors > 1.0 pass through unscaled
    (advisor round-4 finding)."""
    dark = tmp_path / "dark.ply"
    dark.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "element face 1\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0 1 0 1\n1 0 0 1 1 0\n0 1 0 0 1 1\n"
        "3 0 1 2\n")
    mesh = load_model(str(dark)).meshes[0]
    assert mesh.colors.max() <= 1.01 / 255.0     # 1 means 1/255, not 1.0

    hdr = tmp_path / "hdr.ply"
    hdr.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float red\nproperty float green\nproperty float blue\n"
        "element face 1\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0 2.5 0 0\n1 0 0 0 2.5 0\n0 1 0 0 0 2.5\n"
        "3 0 1 2\n")
    mesh = load_model(str(hdr)).meshes[0]
    assert np.isclose(mesh.colors.max(), 2.5)    # HDR floats not divided
