"""Raster correctness corners: near-plane crossing (clipless 2DH), huge
triangles (global-chunk fallback), texture slot exhaustion, bone caps."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trident.ops.raster import visibility
from trident.ops.raster_ref import visibility_ref
from trident.ops.vertex import triangle_setup


def _vis_both(clip, tri_vtx, valid, w, h):
    """Oracle and the binned Triton kernel (Pallas interpreter)."""
    setup = triangle_setup(jnp.asarray(clip), jnp.asarray(tri_vtx),
                           jnp.asarray(valid), w, h)
    ref = visibility_ref(setup, w, h)
    pal = jax.jit(lambda s: visibility(s, w, h, interpret=True))(setup)
    return ref, pal


def test_near_plane_crossing_triangle():
    """A triangle with one vertex BEHIND the camera must still rasterize
    its in-front part (homogeneous rasterization needs no clipping)."""
    w = h = 64
    # camera at origin looking -z (identity view), perspective-ish clip:
    # construct clip coords directly: v0 in front, v1 in front, v2 behind
    clip = np.array([
        [-0.8, -0.5, 0.2, 1.0],
        [0.8, -0.5, 0.2, 1.0],
        [0.0, 0.5, -0.5, -0.5],   # w<0: behind the eye
    ], np.float32)
    tri = np.array([[0, 1, 2]], np.int32)
    ref, pal = _vis_both(clip, tri, np.ones(1, bool), w, h)
    rt, pt = np.asarray(ref.tri_id), np.asarray(pal.tri_id)
    assert (rt >= 0).sum() > 50          # visible region exists
    assert (rt != pt).sum() == 0         # kernel agrees with oracle
    # coverage hugs the in-front edge (ndc y=-0.5 → row ~16, y-down);
    # the behind-vertex's mirror region (bottom) must stay empty
    rows = np.where((rt >= 0).any(axis=1))[0]
    assert rows.max() < h // 2


def test_huge_triangle_global_path():
    """One triangle covering the whole screen exceeds the binning span and
    must flow through the whale (every-tile) path."""
    w, h = 256, 128
    clip = np.array([
        [-4.0, -4.0, 0.5, 1.0],
        [4.0, -4.0, 0.5, 1.0],
        [0.0, 6.0, 0.5, 1.0],
    ], np.float32)
    tri = np.array([[0, 1, 2]], np.int32)
    ref, pal = _vis_both(clip, tri, np.ones(1, bool), w, h)
    rt, pt = np.asarray(ref.tri_id), np.asarray(pal.tri_id)
    assert (rt >= 0).mean() > 0.9        # nearly full coverage
    assert (rt != pt).sum() == 0


def test_mixed_huge_and_small():
    w = h = 128
    rng = np.random.default_rng(3)
    tris = [np.array([[-4, -4, 0.9, 1], [4, -4, 0.9, 1], [0, 6, 0.9, 1]],
                     np.float32)]  # far background quad-ish
    for _ in range(50):              # small near triangles on top
        c = rng.uniform(-0.8, 0.8, (1, 3)) * [1, 1, 0]
        t = c + rng.uniform(-0.1, 0.1, (3, 3))
        t[:, 2] = 0.3
        tris.append(np.concatenate([t, np.ones((3, 1))], -1).astype(np.float32))
    clip = np.concatenate(tris, axis=0)
    tri_vtx = np.arange(clip.shape[0], dtype=np.int32).reshape(-1, 3)
    ref, pal = _vis_both(clip, tri_vtx, np.ones(51, bool), w, h)
    rt, pt = np.asarray(ref.tri_id), np.asarray(pal.tri_id)
    assert (rt != pt).sum() == 0
    assert (rt > 0).sum() > 100          # small tris won over the big one


def test_texture_slot_exhaustion():
    from trident.render.textures import TextureSlots

    slots = TextureSlots(max_slots=4, edge=8)
    a = slots.acquire("a", np.zeros((4, 4, 4), np.uint8))
    b = slots.acquire("b", np.zeros((4, 4, 4), np.uint8))
    c = slots.acquire("c", np.zeros((4, 4, 4), np.uint8))
    d = slots.acquire("d", np.zeros((4, 4, 4), np.uint8))  # out of slots
    assert [a, b, c] == [1, 2, 3]
    assert d == 0                        # white fallback like the reference
    assert slots.acquire("b") == 2       # cache hit unaffected


def test_bone_cap_respected():
    from trident.render.frame import DrawRecord, build_draw_params

    bones = np.tile(np.eye(4, dtype=np.float32), (200, 1, 1))
    rec = DrawRecord(entity=1, mesh_index=0, model=np.eye(4, dtype=np.float32),
                     tint=np.ones(4, np.float32), uv_scale=np.ones(2, np.float32),
                     uv_offset=np.zeros(2, np.float32), tiling=1.0,
                     texture_slot=0, material_index=0, bone_matrices=bones)
    params, palette, _shade = build_draw_params([rec], 4, max_bones=128)
    assert int(params.bone_count[0]) == 128   # clamped like the reference
    assert palette.shape[0] >= 128


def test_pallas_empty_scene():
    """Zero valid triangles: every tile must still initialize (sentinels)."""
    w, h = 128, 64
    clip = np.zeros((3, 4), np.float32)
    tri = np.array([[0, 1, 2]], np.int32)
    ref, pal = _vis_both(clip, tri, np.zeros(1, bool), w, h)
    assert (np.asarray(pal.tri_id) == -1).all()
    assert (np.asarray(pal.depth) == 1.0).all()
    assert (np.asarray(ref.tri_id) == -1).all()
