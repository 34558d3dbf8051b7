"""Procedural primitive meshes: quad / cube / UV-sphere.

Shapes, UVs, tangent frames and winding match the reference's CPU builders
(Renderer.cpp:72-246): unit quad in the XY plane; 24-vertex cube with
per-face normals; 16-ring × 24-segment sphere of radius 0.5. Winding is
counter-clockwise front faces under the Y-flipped projection.
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from trident.geometry.mesh import Mesh


class PrimitiveType(Enum):
    NONE = 0
    CUBE = 1
    SPHERE = 2
    QUAD = 3


def build_quad(material_index: int = 0) -> Mesh:
    positions = np.array([
        [-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0],
    ], dtype=np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32)
    # Wound to match the cube/sphere convention so a quad facing the camera
    # renders. (The reference's quad is wound opposite to its own cube —
    # Renderer.cpp:101 vs :166 — we side with the cube, which is what its
    # scenes visibly use.)
    indices = np.array([0, 2, 1, 0, 3, 2], dtype=np.int32)
    v = positions.shape[0]
    return Mesh(
        positions, indices,
        normals=np.tile([0.0, 0.0, 1.0], (v, 1)),
        tangents=np.tile([1.0, 0.0, 0.0], (v, 1)),
        bitangents=np.tile([0.0, 1.0, 0.0], (v, 1)),
        uvs=uvs, material_index=material_index, name="quad",
    )


_CUBE_FACES = [
    # (normal, tangent, bitangent, 4 corner positions)
    ((0, 0, 1), (1, 0, 0), (0, 1, 0),
     [(-0.5, -0.5, 0.5), (0.5, -0.5, 0.5), (0.5, 0.5, 0.5), (-0.5, 0.5, 0.5)]),
    ((0, 0, -1), (-1, 0, 0), (0, 1, 0),
     [(0.5, -0.5, -0.5), (-0.5, -0.5, -0.5), (-0.5, 0.5, -0.5), (0.5, 0.5, -0.5)]),
    ((1, 0, 0), (0, 0, -1), (0, 1, 0),
     [(0.5, -0.5, 0.5), (0.5, -0.5, -0.5), (0.5, 0.5, -0.5), (0.5, 0.5, 0.5)]),
    ((-1, 0, 0), (0, 0, 1), (0, 1, 0),
     [(-0.5, -0.5, -0.5), (-0.5, -0.5, 0.5), (-0.5, 0.5, 0.5), (-0.5, 0.5, -0.5)]),
    ((0, 1, 0), (1, 0, 0), (0, 0, -1),
     [(-0.5, 0.5, 0.5), (0.5, 0.5, 0.5), (0.5, 0.5, -0.5), (-0.5, 0.5, -0.5)]),
    ((0, -1, 0), (1, 0, 0), (0, 0, 1),
     [(-0.5, -0.5, -0.5), (0.5, -0.5, -0.5), (0.5, -0.5, 0.5), (-0.5, -0.5, 0.5)]),
]


def build_cube(material_index: int = 0) -> Mesh:
    positions, normals, tangents, bitangents, uvs, indices = [], [], [], [], [], []
    face_uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
    offset = 0
    for normal, tangent, bitangent, corners in _CUBE_FACES:
        for i in range(4):
            positions.append(corners[i])
            normals.append(normal)
            tangents.append(tangent)
            bitangents.append(bitangent)
            uvs.append(face_uvs[i])
        indices.extend([offset + 0, offset + 2, offset + 1,
                        offset + 0, offset + 3, offset + 2])
        offset += 4
    return Mesh(
        np.array(positions, np.float32), np.array(indices, np.int32),
        normals=np.array(normals, np.float32),
        tangents=np.array(tangents, np.float32),
        bitangents=np.array(bitangents, np.float32),
        uvs=np.array(uvs, np.float32),
        material_index=material_index, name="cube",
    )


def build_sphere(material_index: int = 0, rings: int = 16, segments: int = 24,
                 radius: float = 0.5) -> Mesh:
    ring_idx = np.arange(rings + 1, dtype=np.float32)
    seg_idx = np.arange(segments + 1, dtype=np.float32)
    v = ring_idx / rings                      # (R+1,)
    u = seg_idx / segments                    # (S+1,)
    phi = v * np.pi
    theta = u * 2.0 * np.pi
    sin_phi, cos_phi = np.sin(phi)[:, None], np.cos(phi)[:, None]
    sin_theta, cos_theta = np.sin(theta)[None, :], np.cos(theta)[None, :]

    px = radius * sin_phi * cos_theta
    py = np.broadcast_to(radius * cos_phi, px.shape)
    pz = radius * sin_phi * sin_theta
    positions = np.stack([px, py, pz], axis=-1).reshape(-1, 3)

    normals = positions / np.maximum(np.linalg.norm(positions, axis=-1, keepdims=True), 1e-8)
    tz = np.broadcast_to(cos_theta, px.shape)
    tx = np.broadcast_to(-sin_theta, px.shape)
    tangents = np.stack([tx, np.zeros_like(tx), tz], axis=-1).reshape(-1, 3)
    t_len = np.linalg.norm(tangents, axis=-1, keepdims=True)
    tangents = np.where(t_len < 1e-4, np.array([1.0, 0.0, 0.0], np.float32), tangents / np.maximum(t_len, 1e-8))
    bitangents = np.cross(normals, tangents)
    b_len = np.linalg.norm(bitangents, axis=-1, keepdims=True)
    bitangents = np.where(b_len < 1e-4, np.array([0.0, 1.0, 0.0], np.float32), bitangents / np.maximum(b_len, 1e-8))

    uu = np.broadcast_to(u[None, :], px.shape)
    vv = np.broadcast_to(v[:, None], px.shape)
    uvs = np.stack([uu, 1.0 - vv], axis=-1).reshape(-1, 2)

    row = segments + 1
    r_grid, s_grid = np.meshgrid(np.arange(rings), np.arange(segments), indexing="ij")
    i0 = r_grid * row + s_grid
    i1 = (r_grid + 1) * row + s_grid
    i2 = (r_grid + 1) * row + s_grid + 1
    i3 = r_grid * row + s_grid + 1
    indices = np.stack([i0, i2, i1, i0, i3, i2], axis=-1).reshape(-1).astype(np.int32)

    return Mesh(
        positions.astype(np.float32), indices,
        normals=normals.astype(np.float32),
        tangents=tangents.astype(np.float32),
        bitangents=bitangents.astype(np.float32),
        uvs=uvs.astype(np.float32),
        material_index=material_index, name="sphere",
    )


def build_primitive(kind: PrimitiveType, material_index: int = 0) -> Mesh:
    if kind == PrimitiveType.CUBE:
        return build_cube(material_index)
    if kind == PrimitiveType.SPHERE:
        return build_sphere(material_index)
    if kind == PrimitiveType.QUAD:
        return build_quad(material_index)
    raise ValueError(f"cannot build primitive {kind}")
