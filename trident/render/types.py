"""Jit-facing pytrees for the render pipeline.

These replace the reference's GPU objects:
  GeometryBuffers   <- the shared vertex/index device buffers (Renderer.cpp:1965-2116)
  DrawPlan          <- the per-frame draw list flattened to arrays (expanded
                       instancing; replaces the per-draw vkCmdDrawIndexed loop)
  DrawParams        <- RenderablePushConstant fields, batched (RenderData.h:14-30)
  CameraParams      <- view/proj rows of GlobalUniformBuffer
  LightParams       <- light rows of GlobalUniformBuffer (UniformBuffer.h:17-28)
  TextureArrays     <- the 256-slot combined-image-sampler array (Pipeline.h:18)
  FrameOutput       <- swapchain image analogue + aux telemetry

All are NamedTuples (automatic pytrees). Static shapes: DrawPlan arrays are
padded to shape buckets so scene edits don't retrace.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


class GeometryBuffers(NamedTuple):
    positions: Array      # (V,3) f32
    normals: Array        # (V,3) f32
    tangents: Array       # (V,3) f32
    bitangents: Array     # (V,3) f32
    colors: Array         # (V,3) f32
    uvs: Array            # (V,2) f32
    bone_indices: Array   # (V,4) i32 (-1 = none)
    bone_weights: Array   # (V,4) f32
    attr_table: Array     # (V,12) f32 packed pos(3) nrm(3) uv(2) col(3) pad —
                          # ONE gather row for the vertex stage


class DrawPlan(NamedTuple):
    """Expanded (instanced) geometry index arrays. Entity instancing is
    resolved host-side into gather indices; triangles reference the expanded
    vertex space. Padded entries point at vertex 0 of draw 0 with
    tri_valid=0."""

    vtx_src: Array       # (TV,) i32 — gather index into GeometryBuffers
    vtx_draw: Array      # (TV,) i32 — draw id per expanded vertex
    tri_vtx: Array       # (TT,3) i32 — expanded-vertex ids per triangle
    tri_valid: Array     # (TT,) bool
    num_draws: int       # static


class DrawParams(NamedTuple):
    """Per-draw state, batched over D draws (push-constant analogue).
    xform_a/xform_b pack the model matrix + UV transform into two gather
    rows (flat model[0:12] | model[12:16], uv_scale, uv_offset, tiling...)."""

    model: Array          # (D,4,4) f32
    xform_a: Array        # (D,12) f32 — model rows 0..2 flattened
    xform_b: Array        # (D,12) f32 — model row 3, uv_scale, uv_offset, tiling, pad
    tint: Array           # (D,4) f32
    uv_scale: Array       # (D,2) f32
    uv_offset: Array      # (D,2) f32
    tiling: Array         # (D,) f32
    texture_slot: Array   # (D,) i32
    material_index: Array # (D,) i32
    bone_offset: Array    # (D,) i32 — into the global palette, -1 = unskinned
    bone_count: Array     # (D,) i32


class CameraParams(NamedTuple):
    view: Array           # (4,4) f32
    proj: Array           # (4,4) f32
    position: Array       # (3,) f32


class LightParams(NamedTuple):
    ambient: Array            # (4,) rgb + intensity
    dir_direction: Array      # (3,) f32
    dir_color: Array          # (4,) rgb + intensity
    dir_count: Array          # () i32 (0 or 1)
    point_pos_range: Array    # (8,4) xyz + radius
    point_color_intensity: Array  # (8,4) rgb + intensity
    point_count: Array        # () i32


class MaterialTable(NamedTuple):
    params: Array         # (M,8) f32: rgba, metallic, roughness, ambient, rsv
    texture_slot: Array   # (M,) i32


class TextureArrays(NamedTuple):
    """Slot-indexed texture storage: per-slot mip pyramids of 2×2 TEXEL
    QUADS packed into ONE flat buffer, each slot padded only to ITS OWN
    pow2 edge (memory ∝ actual texels; the reference binds native-size
    images, TextureLoader.cpp:293).

    Levels are (e+1)×(e+1) tiles with wrap-gutter column lw := col 0 and
    row lh := row 0 (REPEAT at the ACTUAL footprint), and quads[i] holds
    [(x,y),(x+1,y),(x,y+1),(x+1,y+1)] — a full bilinear tap is ONE
    16-byte gather (nearest one, trilinear two): the 4× texel
    duplication trades memory for fewer per-pixel gathers. Level offsets
    within a slot are CLOSED FORM (ops/shading._level_geom), so sampling
    needs no offset tables. Slot bases are 256-entry aligned (base>>8
    stays exact in f32). Slot 0 is the 1×1-white analogue; sizes[s,0:2] is
    the actual (w,h) footprint for REPEAT wrap."""

    quads: Array              # (N, 4) uint32 RGBA8 — all slots, flat
    sizes: Array              # (S,4) i32: actual w, actual h,
                              #   flat base >> 8, pow2 edge E_s
    max_level: Array          # () i32 — log2(max slot edge): mip clamp


class SkyboxCube(NamedTuple):
    faces: Array          # (6, E, E, 3) f32 — +x,-x,+y,-y,+z,-z
    valid: Array          # () bool — false → clear color fallback


class AiBlend(NamedTuple):
    image: Array          # (H,W,3) f32 — last interpolated frame
    blend: Array          # () f32 — 0 disables


class ShadowParams(NamedTuple):
    """Directional-light shadow map (two-pass render graph). The reference
    only reserves a shadow-caster flag (LightComponent); this implements it."""

    depth: Array          # (S,S) f32 light-space depth map
    light_vp: Array       # (4,4) f32 light view-projection
    enabled: Array        # () bool
    bias: Array           # () f32 depth bias


class FramebufferConfig(NamedTuple):
    """Static config (hashable; passed as static argnum)."""

    width: int
    height: int
    msaa: int = 1
    clear_color: Tuple[float, float, float, float] = (0.05, 0.05, 0.08, 1.0)


class GBuffer(NamedTuple):
    """Visibility-pass output: per-pixel winner triangle + depth."""

    tri_id: Array         # (H,W) i32 — -1 = background
    depth: Array          # (H,W) f32 — ndc z in [0,1]
    aux: Optional[Array] = None  # (2,) i32 raster drop counters
                                 # [truncated pairs, dropped big chunks]


class FrameOutput(NamedTuple):
    color: Array          # (H,W,4) uint8
    depth: Array          # (H,W) f32
    tri_id: Array         # (H,W) i32
    aux: Optional[Array] = None  # (2,) i32 raster drop counters (None on
                                 # the ref-raster path, which cannot drop)
    history: Optional[Array] = None
                          # upscaler-V2 temporal history: the (h, w, 12)
                          # uint8 OUTPUT BLOCKS (2×2·rgb, depth-to-space
                          # pending) — next frame's warp gathers from this
                          # directly, skipping the 4K space-to-depth
                          # relayout that dominated the V1 warp


def zero_light_params() -> LightParams:
    return LightParams(
        ambient=jnp.zeros(4, jnp.float32),
        dir_direction=jnp.array([0.0, -1.0, 0.0], jnp.float32),
        dir_color=jnp.zeros(4, jnp.float32),
        dir_count=jnp.array(0, jnp.int32),
        point_pos_range=jnp.zeros((8, 4), jnp.float32),
        point_color_intensity=jnp.zeros((8, 4), jnp.float32),
        point_count=jnp.array(0, jnp.int32),
    )
