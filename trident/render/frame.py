"""Per-frame draw gathering: ECS registry → packed draw arrays.

Replaces GatherMeshDraws / the per-draw push-constant loop
(Renderer.cpp:2910-3042, 5110-5151). The expensive index expansion (which
entity instances which mesh) is cached by scene topology; per-frame work is
only the cheap numpy packing of transforms/tints/palettes.

Shape discipline: expanded vertex/triangle counts and draw counts are padded
to power-of-two buckets so adding an entity rarely retriggers XLA
compilation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from trident.ecs.components import (
    AnimationComponent,
    MeshComponent,
    SpriteComponent,
    TextureComponent,
    TransformComponent,
)
from trident.ecs.registry import Registry
from trident.geometry.mesh import GeometryCache, PackedGeometry
from trident.mathx.transforms import compose_trs
from trident.render.types import DrawParams, DrawPlan, GeometryBuffers


@dataclass
class DrawRecord:
    """One mesh draw (host-side intermediate)."""

    entity: int
    mesh_index: int
    model: np.ndarray            # (4,4)
    tint: np.ndarray             # (4,)
    uv_scale: np.ndarray         # (2,)
    uv_offset: np.ndarray        # (2,)
    tiling: float
    texture_slot: int
    material_index: int
    bone_matrices: Optional[np.ndarray]  # (B,4,4) or None


def gather_mesh_draws(registry: Registry, cache: GeometryCache) -> List[DrawRecord]:
    records: List[DrawRecord] = []
    for entity, (transform, mesh) in registry.view(TransformComponent, MeshComponent):
        if not mesh.visible or mesh.mesh_index < 0 or mesh.mesh_index >= len(cache.meshes):
            continue
        model = np.asarray(compose_trs(transform.position, transform.rotation,
                                       transform.scale), np.float32)
        material_index = (mesh.material_index
                          if 0 <= mesh.material_index < len(cache.materials) else 0)
        texture_slot = cache.materials[material_index].texture_slot
        uv_scale = np.ones(2, np.float32)
        uv_offset = np.zeros(2, np.float32)
        tiling = 1.0
        tex = registry.try_get(entity, TextureComponent)
        if tex is not None:
            texture_slot = tex.slot
            uv_scale = np.asarray(tex.uv_scale, np.float32)
            uv_offset = np.asarray(tex.uv_offset, np.float32)
            tiling = float(tex.tiling)
        anim = registry.try_get(entity, AnimationComponent)
        bones = anim.bone_matrices if anim is not None else None
        records.append(DrawRecord(
            entity=entity, mesh_index=mesh.mesh_index, model=model,
            tint=np.asarray(mesh.tint, np.float32),
            uv_scale=uv_scale, uv_offset=uv_offset, tiling=tiling,
            texture_slot=texture_slot, material_index=material_index,
            bone_matrices=bones,
        ))
    return records


def gather_sprite_draws(registry: Registry, cache: GeometryCache,
                        quad_mesh_index: int, time_s: float = 0.0,
                        texture_lookup=None) -> List[DrawRecord]:
    """Sprites → textured-quad draw records (reference: GatherSpriteDraws,
    Renderer.cpp:2996). Atlas tiles select a UV window; animation_speed
    cycles the atlas index with time; sort_offset biases Z via the model
    matrix's translation (painter-style bias, not true blending)."""
    records: List[DrawRecord] = []
    for entity, (transform, sprite) in registry.view(TransformComponent, SpriteComponent):
        if not sprite.visible:
            continue
        model = np.asarray(compose_trs(transform.position, transform.rotation,
                                       transform.scale), np.float32)
        if sprite.sort_offset:
            model = model.copy()
            model[2, 3] += sprite.sort_offset
        tiles = max(int(sprite.atlas_tiles), 1)
        index = int(sprite.atlas_index)
        if sprite.animation_speed > 0.0:
            index = (index + int(time_s * sprite.animation_speed)) % (tiles * tiles)
        uv_scale = np.asarray(sprite.uv_scale, np.float32) / tiles
        uv_offset = (np.asarray(sprite.uv_offset, np.float32)
                     + np.array([index % tiles, index // tiles], np.float32) / tiles)
        slot = sprite.texture_slot
        if slot == 0 and sprite.texture_path and texture_lookup is not None:
            slot = texture_lookup(sprite.texture_path)
        records.append(DrawRecord(
            entity=entity, mesh_index=quad_mesh_index, model=model,
            tint=np.asarray(sprite.tint, np.float32),
            uv_scale=uv_scale, uv_offset=uv_offset, tiling=float(sprite.tiling),
            texture_slot=slot, material_index=0, bone_matrices=None,
        ))
    return records


def _bucket(n: int, minimum: int = 16) -> int:
    if n <= 0:
        return minimum
    return max(minimum, 1 << (n - 1).bit_length())


class DrawPlanCache:
    """Caches the expanded index arrays keyed by (geometry version, the
    tuple of mesh indices drawn). Per-frame params are rebuilt cheaply."""

    def __init__(self) -> None:
        self._key: Optional[tuple] = None
        self._plan: Optional[DrawPlan] = None
        self._tri_draw: Optional[jnp.ndarray] = None
        self._corner_t: Optional[jnp.ndarray] = None
        # monotone rebuild counter: cache signatures key on this instead of
        # id(plan) (CPython recycles ids of freed objects)
        self.version = 0
        # uniform instancing layout (all draws one mesh): draw d owns
        # triangles [d*draw_stride, (d+1)*draw_stride). 0 = non-uniform —
        # corner_stage then falls back to the (T,48) draw-row gather.
        self.draw_stride = 0
        self.real_draws = 0

    def plan(self, packed: PackedGeometry, records: List[DrawRecord],
             geometry_version: int) -> Tuple[DrawPlan, jnp.ndarray]:
        key = (geometry_version, tuple(r.mesh_index for r in records))
        if key == self._key and self._plan is not None:
            return self._plan, self._tri_draw
        plan, tri_draw = build_draw_plan(packed, records)
        self._key, self._plan, self._tri_draw = key, plan, tri_draw
        self._corner_t = None
        self.version += 1
        tri_counts = {packed.draw_infos[r.mesh_index].index_count // 3
                      for r in records}
        if records and len(tri_counts) == 1:
            self.draw_stride = tri_counts.pop()
            self.real_draws = len(records)
        else:
            self.draw_stride = 0
            self.real_draws = 0
        return plan, tri_draw

    def corner_table(self, packed: PackedGeometry) -> jnp.ndarray:
        """Device-resident (36, T) planar corner table for the cached plan
        (ops/corner.py) — built lazily once per topology."""
        if self._corner_t is None:
            from trident.ops.corner import build_corner_table

            attr = np.concatenate(
                [packed.positions, packed.normals, packed.uvs, packed.colors,
                 np.zeros((packed.positions.shape[0], 1), np.float32)],
                axis=1)
            self._corner_t = jnp.asarray(build_corner_table(
                attr, np.asarray(self._plan.vtx_src),
                np.asarray(self._plan.tri_vtx)))
        return self._corner_t


def build_draw_plan(packed: PackedGeometry,
                    records: List[DrawRecord]) -> Tuple[DrawPlan, jnp.ndarray]:
    """Expand instanced draws into flat gather arrays.

    Returns (DrawPlan, tri_draw (TT,) i32 — draw id per triangle)."""
    vtx_src_parts: List[np.ndarray] = []
    vtx_draw_parts: List[np.ndarray] = []
    tri_parts: List[np.ndarray] = []
    tri_draw_parts: List[np.ndarray] = []
    v_cursor = 0
    for d, rec in enumerate(records):
        info = packed.draw_infos[rec.mesh_index]
        vcount_start = info.base_vertex
        # vertex span of this mesh: its indices are local [0, vcount)
        mesh_indices = packed.indices[info.first_index:info.first_index + info.index_count]
        vcount = int(mesh_indices.max()) + 1 if info.index_count else 0
        vtx_src_parts.append(np.arange(vcount_start, vcount_start + vcount, dtype=np.int32))
        vtx_draw_parts.append(np.full(vcount, d, np.int32))
        tri = mesh_indices.reshape(-1, 3).astype(np.int32) + v_cursor
        tri_parts.append(tri)
        tri_draw_parts.append(np.full(tri.shape[0], d, np.int32))
        v_cursor += vcount

    if records:
        vtx_src = np.concatenate(vtx_src_parts)
        vtx_draw = np.concatenate(vtx_draw_parts)
        tri_vtx = np.concatenate(tri_parts)
        tri_draw = np.concatenate(tri_draw_parts)
    else:
        vtx_src = np.zeros(0, np.int32)
        vtx_draw = np.zeros(0, np.int32)
        tri_vtx = np.zeros((0, 3), np.int32)
        tri_draw = np.zeros(0, np.int32)

    tv = _bucket(len(vtx_src))
    tt = _bucket(tri_vtx.shape[0])
    n_draws = _bucket(len(records), minimum=4)

    vtx_src_p = np.zeros(tv, np.int32)
    vtx_src_p[: len(vtx_src)] = vtx_src
    vtx_draw_p = np.zeros(tv, np.int32)
    vtx_draw_p[: len(vtx_draw)] = vtx_draw
    tri_vtx_p = np.zeros((tt, 3), np.int32)
    tri_vtx_p[: tri_vtx.shape[0]] = tri_vtx
    tri_valid = np.zeros(tt, bool)
    tri_valid[: tri_vtx.shape[0]] = True
    tri_draw_p = np.zeros(tt, np.int32)
    tri_draw_p[: tri_draw.shape[0]] = tri_draw

    plan = DrawPlan(
        vtx_src=jnp.asarray(vtx_src_p),
        vtx_draw=jnp.asarray(vtx_draw_p),
        tri_vtx=jnp.asarray(tri_vtx_p),
        tri_valid=jnp.asarray(tri_valid),
        num_draws=n_draws,
    )
    return plan, jnp.asarray(tri_draw_p)


def build_draw_params(records: List[DrawRecord], num_draws: int,
                      max_bones: int = 128,
                      material_table: Optional[np.ndarray] = None,
                      ) -> Tuple[DrawParams, jnp.ndarray, jnp.ndarray]:
    """Pack per-draw state + the global bone palette + the shade table.

    Returns (DrawParams, palette (P,4,4) f32, shade_table (D,8) f32).
    shade_table row: color_factor rgba (= material base-color × tint),
    metallic, roughness, ambient_strength, texture slot (f32) — the single
    per-draw gather row the deferred pass needs. Palette bucket-padded."""
    d = num_draws
    model = np.tile(np.eye(4, dtype=np.float32), (d, 1, 1))
    tint = np.ones((d, 4), np.float32)
    uv_scale = np.ones((d, 2), np.float32)
    uv_offset = np.zeros((d, 2), np.float32)
    tiling = np.ones(d, np.float32)
    texture_slot = np.zeros(d, np.int32)
    material_index = np.zeros(d, np.int32)
    bone_offset = np.full(d, -1, np.int32)
    bone_count = np.zeros(d, np.int32)

    shade = np.zeros((d, 8), np.float32)
    shade[:, 0:4] = 1.0
    shade[:, 5] = 1.0  # roughness
    shade[:, 6] = 1.0  # ambient strength

    palette_parts: List[np.ndarray] = []
    p_cursor = 0
    for i, rec in enumerate(records[:d]):
        model[i] = rec.model
        tint[i] = rec.tint
        if material_table is not None and 0 <= rec.material_index < material_table.shape[0]:
            mat = material_table[rec.material_index]
            shade[i, 0:4] = mat[0:4] * rec.tint
            shade[i, 4] = mat[4]   # metallic
            shade[i, 5] = mat[5]   # roughness
            shade[i, 6] = mat[6]   # ambient strength
        else:
            shade[i, 0:4] = rec.tint
        shade[i, 7] = float(rec.texture_slot)
        uv_scale[i] = rec.uv_scale
        uv_offset[i] = rec.uv_offset
        tiling[i] = rec.tiling
        texture_slot[i] = rec.texture_slot
        material_index[i] = rec.material_index
        if rec.bone_matrices is not None and len(rec.bone_matrices) > 0:
            bones = np.asarray(rec.bone_matrices, np.float32)[:max_bones]
            bone_offset[i] = p_cursor
            bone_count[i] = bones.shape[0]
            palette_parts.append(bones)
            p_cursor += bones.shape[0]

    if palette_parts:
        palette = np.concatenate(palette_parts, axis=0)
    else:
        palette = np.eye(4, dtype=np.float32)[None]
    p = _bucket(palette.shape[0], minimum=1)
    palette_p = np.tile(np.eye(4, dtype=np.float32), (p, 1, 1))
    palette_p[: palette.shape[0]] = palette

    model_flat = model.reshape(d, 16)
    xform_a = model_flat[:, :12].copy()
    xform_b = np.concatenate(
        [model_flat[:, 12:16], uv_scale, uv_offset, tiling[:, None],
         np.zeros((d, 3), np.float32)], axis=1)
    # numpy-backed: per-frame state ships to the device as ONE packed blob
    # (render/bundle.py) — premature jnp.asarray here would upload ~13
    # small arrays per frame
    params = DrawParams(
        model=model, xform_a=xform_a, xform_b=xform_b, tint=tint,
        uv_scale=uv_scale, uv_offset=uv_offset, tiling=tiling,
        texture_slot=texture_slot, material_index=material_index,
        bone_offset=bone_offset, bone_count=bone_count,
    )
    return params, palette_p, shade


def geometry_to_device(packed: PackedGeometry) -> GeometryBuffers:
    v = packed.positions.shape[0]
    attr_table = np.concatenate(
        [packed.positions, packed.normals, packed.uvs, packed.colors,
         np.zeros((v, 1), np.float32)], axis=1)
    return GeometryBuffers(
        positions=jnp.asarray(packed.positions),
        normals=jnp.asarray(packed.normals),
        tangents=jnp.asarray(packed.tangents),
        bitangents=jnp.asarray(packed.bitangents),
        colors=jnp.asarray(packed.colors),
        uvs=jnp.asarray(packed.uvs),
        bone_indices=jnp.asarray(packed.bone_indices),
        bone_weights=jnp.asarray(packed.bone_weights),
        attr_table=jnp.asarray(attr_table),
    )
