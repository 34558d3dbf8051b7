"""The renderer: scene arrays in, frames out.

Replaces the reference's Renderer god-object + RenderCommand facade
(Renderer/Renderer.h:77-598, RenderCommand.h:11-85). The entire Vulkan
command-buffer/descriptor/barrier machinery collapses into ONE jitted
function per (framebuffer size, pipeline flavor); everything else is
host-side state management:

  * GeometryCache + TextureSlots own assets; device uploads happen only on
    version bumps (the UploadMeshFromCache analogue)
  * DrawPlanCache re-expands instancing only on topology changes
  * frames-in-flight = a ring of un-awaited device futures (XLA async
    dispatch replaces fences/semaphores)
  * per-viewport offscreen targets = separate render calls with their own
    camera + size (Renderer.cpp:4576-4856)
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from trident.core.config import EngineConfig
from trident.core.log import get_logger
from trident.core.platform import raster_interpret, raster_mode
from trident.core.timing import FrameTimingRing, Time
from trident.ecs.registry import Registry
from trident.geometry.mesh import GeometryCache, Material, Mesh
from trident.geometry.primitives import PrimitiveType, build_primitive
from trident.ops.deferred import deferred_shade, pack_rgba8
from trident.ops.raster import rasterize
from trident.ops.vertex import triangle_setup, vertex_stage
from trident.render.camera import Camera, EditorCamera, RuntimeCamera
from trident.render.frame import (
    DrawPlanCache,
    build_draw_params,
    gather_mesh_draws,
    gather_sprite_draws,
    geometry_to_device,
)
from trident.render.lights import gather_lights
from trident.render.textures import TextureSlots
from trident.render.types import (
    AiBlend,
    CameraParams,
    FrameOutput,
    SkyboxCube,
)

logger = get_logger("renderer")


def _visibility_and_shade(setup, planes, textures, camera, lights,
                          skybox, *, width: int, height: int, clear_color,
                          raster: str, chunk: int, sampling: str,
                          shadow, shadow_pcf: bool, tonemap: bool,
                          interpret: bool, y_offset=0, full_height=None,
                          shader_fn=None):
    """Rasterize + shade a frame (or a horizontal band of one) from
    prebuilt per-triangle setup and attribute planes. `y_offset` (int or
    traced i32) +
    `full_height`: this target is the band of a full_height frame
    starting at that global pixel row; `camera` is always the FULL-frame
    camera — all arithmetic runs at global pixel coordinates, so bands
    are bit-identical to the single-chip render. Returns (frame, gbuf)."""
    gbuf = rasterize(setup, width, height, raster=raster,
                     interpret=interpret, chunk=chunk, y_offset=y_offset)
    frame = deferred_shade(gbuf, planes, textures, camera, lights,
                           width, height, clear_color=clear_color,
                           skybox=skybox, ai=None, sampling=sampling,
                           shadow=shadow, shadow_pcf=shadow_pcf,
                           tonemap=tonemap, y_offset=y_offset,
                           full_height=full_height, shader_fn=shader_fn)
    return frame, gbuf


def _render_frame_impl(geometry, plan, tri_draw, params, palette, shade_table,
                       camera, lights, textures, skybox, ai, corner_t=None,
                       upscale_params=None, prev=None,
                       *, width: int, height: int, clear_color,
                       raster: str, chunk: int, skinned: bool,
                       sampling: str = "bilinear",
                       vertex_colors: bool = False,
                       plane_f16: bool = False,
                       light_camera=None, shadow_size: int = 0,
                       shadow_bias: float = 2e-3,
                       shadow_pcf: bool = False,
                       supersample: int = 1,
                       bloom: bool = False,
                       bloom_threshold: float = 1.0,
                       bloom_strength: float = 0.6,
                       draw_stride: int = 0,
                       real_draws: int = 0,
                       shader_fn=None) -> FrameOutput:
    from trident.ops import post
    from trident.ops.deferred import apply_ai_blend
    from trident.ops.planes import build_planes_corners

    rw, rh = width * supersample, height * supersample
    interpret = raster_interpret()
    if corner_t is not None and not skinned:
        # corner-major fast path (ops/corner.py): the static (36,T) corner
        # table replaces the per-frame vertex+corner gathers; ONE (T,48)
        # per-draw-row gather feeds planar setup + world attributes
        from trident.ops.corner import build_draw_rows, corner_stage

        cs = corner_stage(corner_t, build_draw_rows(params, camera, rw, rh),
                          tri_draw, plan.tri_valid, rw, rh,
                          vertex_colors=vertex_colors,
                          draw_stride=draw_stride, real_draws=real_draws)
        setup = cs.setup
        c_nrm, c_uv, c_col = cs.corner_nrm, cs.corner_uv, cs.corner_col
    else:
        # indexed path (skinning needs per-vertex palette gathers): ONE
        # (T,3,16) packed-corner gather feeds setup AND the plane build
        verts = vertex_stage(geometry, plan, params, camera, palette,
                             skinned=skinned)
        corners = verts.packed[plan.tri_vtx]                   # (T,3,16)
        setup = triangle_setup(corners[..., 0:4], None, plan.tri_valid,
                               rw, rh)
        c_nrm, c_uv = corners[..., 4:7], corners[..., 7:9]
        c_col = corners[..., 9:12] if vertex_colors else None

    shadow = None
    if shadow_size and light_camera is not None:
        from trident.ops.shadow import render_shadow_map
        from trident.render.types import ShadowParams

        depth_map = render_shadow_map(geometry, plan, params, light_camera,
                                      palette, shadow_size, skinned, raster,
                                      corner_t=corner_t, tri_draw=tri_draw,
                                      draw_stride=draw_stride,
                                      real_draws=real_draws)
        shadow = ShadowParams(
            depth=depth_map,
            light_vp=jnp.matmul(light_camera.proj, light_camera.view,
                                precision=jax.lax.Precision.HIGHEST),
            enabled=jnp.asarray(True),
            bias=jnp.asarray(shadow_bias, jnp.float32))

    planes = build_planes_corners(setup, c_nrm, c_uv, tri_draw, shade_table,
                                  corner_col=c_col, f16=plane_f16)
    frame, gbuf = _visibility_and_shade(
        setup, planes, textures, camera, lights, skybox,
        width=rw, height=rh, clear_color=clear_color, raster=raster,
        chunk=chunk, sampling=sampling, shadow=shadow,
        shadow_pcf=shadow_pcf, tonemap=not bloom, interpret=interpret,
        shader_fn=shader_fn)
    if bloom:
        from trident.ops.shading import tonemap_reinhard_gamma

        hdr = post.bloom(frame[..., :3], bloom_threshold, bloom_strength)
        frame = jnp.concatenate(
            [tonemap_reinhard_gamma(hdr), frame[..., 3:4]], axis=-1)
    frame = post.resolve_supersample(frame, supersample)
    history = None
    if upscale_params is not None:
        # neural 2x reconstruction (ai/upscaler.py): width/height here are
        # the HALF-res render dims; the output frame is full size. The AI
        # blend then applies at display resolution.
        from trident.ai import upscaler as up

        d_half = gbuf.depth[::supersample, ::supersample]
        # prev = (previous history, previous view-projection): V1 = the
        # full-res packed color, V2 = the (h, w, 12) output blocks
        # (temporal_from_prev dispatches on the channel count, so the
        # first frame after a knob flip still warps correctly)
        temporal = up.temporal_from_prev(upscale_params, prev, d_half,
                                         camera, width * 2, height * 2)
        if up.V2:
            rgb, blocks = up.apply_upscaler_v2(
                upscale_params, frame[..., :3], temporal, depth=d_half)
            history = up.blocks_to_u8(blocks)
        else:
            rgb = up.apply_upscaler(upscale_params, frame[..., :3],
                                    temporal, depth=d_half)
        alpha = jnp.repeat(jnp.repeat(frame[..., 3:4], 2, axis=0), 2, axis=1)
        frame = jnp.concatenate([rgb, alpha], axis=-1)
    frame = jnp.clip(apply_ai_blend(frame, ai), 0.0, 1.0)

    # depth/tri surfaced at render resolution's top-left sample for tooling
    depth_out = gbuf.depth[::supersample, ::supersample]
    tri_out = gbuf.tri_id[::supersample, ::supersample]
    if upscale_params is not None:
        depth_out = jnp.repeat(jnp.repeat(depth_out, 2, axis=0), 2, axis=1)
        tri_out = jnp.repeat(jnp.repeat(tri_out, 2, axis=0), 2, axis=1)
    return FrameOutput(color=pack_rgba8(frame), depth=depth_out,
                       tri_id=tri_out, aux=gbuf.aux, history=history)


@functools.partial(jax.jit, static_argnames=("width", "height", "clear_color",
                                             "raster", "chunk", "skinned",
                                             "sampling", "vertex_colors",
                                             "plane_f16",
                                             "shadow_size", "shadow_bias",
                                             "shadow_pcf",
                                             "supersample", "bloom",
                                             "bloom_threshold",
                                             "bloom_strength",
                                             "draw_stride", "real_draws",
                                             "shader_fn", "kcfg"))
def render_frame(geometry, plan, tri_draw, params, palette, shade_table,
                 camera, lights, textures, skybox, ai, light_camera=None,
                 corner_t=None, upscale_params=None, prev=None,
                 *, width, height, clear_color, raster, chunk, skinned,
                 sampling="bilinear", vertex_colors=False, plane_f16=True,
                 shadow_size=0,
                 shadow_bias=2e-3, shadow_pcf=False, supersample=1,
                 bloom=False, bloom_threshold=1.0,
                 bloom_strength=0.6, draw_stride=0,
                 real_draws=0, shader_fn=None, kcfg=None) -> FrameOutput:
    # kcfg: the active kernel_knobs.trace_key() (None when no AI feature
    # is on) — a pure jit-cache key so renders under different upscaler
    # knob sets never share a trace
    return _render_frame_impl(
        geometry, plan, tri_draw, params, palette, shade_table, camera,
        lights, textures, skybox, ai, corner_t, upscale_params, prev,
        width=width, height=height,
        clear_color=clear_color, raster=raster, chunk=chunk, skinned=skinned,
        sampling=sampling, vertex_colors=vertex_colors, plane_f16=plane_f16,
        light_camera=light_camera, shadow_size=shadow_size,
        shadow_bias=shadow_bias, shadow_pcf=shadow_pcf,
        supersample=supersample, bloom=bloom,
        bloom_threshold=bloom_threshold, bloom_strength=bloom_strength,
        draw_stride=draw_stride, real_draws=real_draws,
        shader_fn=shader_fn)


@functools.partial(jax.jit, static_argnames=(
    "shape", "width", "height", "clear_color", "raster", "chunk", "skinned",
    "sampling", "vertex_colors", "plane_f16", "shadow_size", "shadow_pcf", "supersample", "bloom", "bloom_threshold",
    "bloom_strength", "draw_stride", "real_draws", "shader_fn", "kcfg"))
def render_frame_bundled(geometry, plan, tri_draw, f32, i32, textures,
                         skybox, ai_image, corner_t=None, upscale_params=None,
                         prev=None,
                         *, shape, width, height,
                         clear_color, raster, chunk, skinned,
                         sampling="bilinear", vertex_colors=False,
                         plane_f16=True, shadow_size=0, shadow_pcf=False, supersample=1,
                         bloom=False, bloom_threshold=1.0,
                         bloom_strength=0.6, draw_stride=0,
                         real_draws=0, shader_fn=None,
                         kcfg=None) -> FrameOutput:
    """render_frame with every per-frame host value arriving in TWO packed
    blobs (render/bundle.py) — the interactive path. Uploads per frame:
    f32 blob + i32 blob (+ the AI image at its own cadence); everything
    else is device-resident and version-cached."""
    from trident.render.bundle import unpack_frame

    (params, palette, shade_table, camera, lights, light_cam, ai_blend,
     shadow_bias) = unpack_frame(f32, i32, shape)
    ai = AiBlend(image=ai_image, blend=ai_blend)
    return _render_frame_impl(
        geometry, plan, tri_draw, params, palette, shade_table, camera,
        lights, textures, skybox, ai, corner_t, upscale_params, prev,
        width=width, height=height,
        clear_color=clear_color, raster=raster, chunk=chunk, skinned=skinned,
        sampling=sampling, vertex_colors=vertex_colors, plane_f16=plane_f16,
        light_camera=light_cam if shadow_size else None,
        shadow_size=shadow_size, shadow_bias=shadow_bias,
        shadow_pcf=shadow_pcf, supersample=supersample, bloom=bloom,
        bloom_threshold=bloom_threshold, bloom_strength=bloom_strength,
        draw_stride=draw_stride, real_draws=real_draws,
        shader_fn=shader_fn)


@dataclass
class ViewportContext:
    """One offscreen target (reference: Renderer.h:421-428). ID 1 = scene
    (editor camera), ID 2 = game (runtime camera) by convention."""

    viewport_id: int
    width: int
    height: int
    camera: Optional[Camera] = None
    last_frame: Optional[FrameOutput] = None
    last_sig: Optional[tuple] = None   # idle-frame cache key
    prev_state: Optional[tuple] = None  # (color, view·proj) for the
                                        # temporal upscaler (device arrays)


class Renderer:
    SCENE_VIEWPORT = 1
    GAME_VIEWPORT = 2

    def __init__(self, config: Optional[EngineConfig] = None) -> None:
        self.config = config or EngineConfig()
        rc = self.config.render
        # upscaler knobs (ops/kernel_knobs.py) are module statics the net
        # bakes in at trace time; the active set's trace_key() rides every
        # frame jit as a static arg so two differently-configured
        # Renderers never share traces, and _ensure_knobs() re-applies
        # this renderer's set before each dispatch. Every renderer builds
        # from the env-default baseline, so a previous renderer's overlay
        # never leaks into the next. Without an AI feature the ai package
        # is never imported.
        self._kcfg = self._kcfg_snapshot = None
        if rc.ai_upscale or rc.kernel:
            from trident.ops import kernel_knobs

            kernel_knobs.apply({**kernel_knobs.env_defaults(),
                                **(rc.kernel or {})})
            self._kcfg_snapshot = kernel_knobs.snapshot()
            self._kcfg = kernel_knobs.trace_key()
        self.geometry = GeometryCache()
        self.textures = TextureSlots(max_slots=rc.max_textures, edge=rc.texture_size)
        self.registry: Optional[Registry] = None
        from trident.render.shader_hook import ShaderHook

        self.shader_hook = ShaderHook()
        self.editor_camera = EditorCamera()
        self.runtime_camera = RuntimeCamera()
        self.runtime_camera_ready = False
        self.time = Time()
        self.timing = FrameTimingRing(self.config.capture.perf_dir)
        self.viewports: Dict[int, ViewportContext] = {}
        self.set_viewport(0, rc.width, rc.height)
        self.active_viewport = 0

        self._plan_cache = DrawPlanCache()
        self._device_geometry = None
        self._device_geometry_version = -1
        self._primitive_mesh_indices: Dict[PrimitiveType, int] = {}
        self._skybox: Optional[SkyboxCube] = None
        self._ai_image: Optional[jnp.ndarray] = None
        self.ai_blend: float = 0.0
        self._inflight: List[FrameOutput] = []
        self.max_inflight = 3
        self._vertex_colors = False
        self._vertex_colors_version = -1
        self._banded_jit = None
        self._banded_n = 0
        self._upscaler_params = None
        self._last_records: List = []
        self._last_tri_draw = None
        self.stats_models = 0
        self.stats_triangles = 0

    # -- registry / cameras ---------------------------------------------------
    def set_active_registry(self, registry: Registry) -> None:
        self.registry = registry

    def set_viewport(self, viewport_id: int, width: int, height: int,
                     camera: Optional[Camera] = None) -> ViewportContext:
        ctx = self.viewports.get(viewport_id)
        if ctx is None:
            ctx = ViewportContext(viewport_id, width, height, camera)
            self.viewports[viewport_id] = ctx
        else:
            ctx.width, ctx.height = width, height
            if camera is not None:
                ctx.camera = camera
        return ctx

    def _camera_for(self, ctx: ViewportContext) -> Camera:
        if ctx.camera is not None:
            cam = ctx.camera
        elif ctx.viewport_id == self.GAME_VIEWPORT and self.runtime_camera_ready:
            cam = self.runtime_camera
        else:
            cam = self.editor_camera
        cam.set_viewport_size(ctx.width, ctx.height)
        return cam

    # -- assets -----------------------------------------------------------------
    def append_meshes(self, meshes: List[Mesh], materials: List[Material],
                      source_path: Optional[str] = None) -> Tuple[int, int]:
        """Import a model's meshes+materials (Renderer::AppendMeshes).
        `source_path` registers the model for hot reload."""
        return self.geometry.append(meshes, materials,
                                    source_path=source_path)

    def ensure_primitive(self, kind: PrimitiveType) -> int:
        if kind not in self._primitive_mesh_indices:
            self._primitive_mesh_indices[kind] = self.geometry.add_mesh(build_primitive(kind))
        return self._primitive_mesh_indices[kind]

    def acquire_texture(self, key: str, rgba: Optional[np.ndarray] = None,
                        mips=None) -> int:
        return self.textures.acquire(key, rgba, mips=mips)

    def set_skybox(self, faces: np.ndarray, mips=None) -> None:
        """faces: (6,E,E,3) float in [0,1] ordered +x,-x,+y,-y,+z,-z.
        `mips`: optional list of coarser levels (halved edge each) — the
        full file chain the reference uploads (TextureLoader.cpp:417).
        Rendering picks the level whose angular texel density best matches
        the viewport (a full-frame background's minification ratio is
        frame-constant, so per-frame level selection is the trilinear
        analogue without per-pixel derivative cost)."""
        self._skybox_chain = [jnp.asarray(faces, jnp.float32)] + [
            jnp.asarray(m, jnp.float32) for m in (mips or [])]
        self._skybox = SkyboxCube(
            faces=self._skybox_chain[0],
            valid=jnp.asarray(True),
        )
        self._skybox_version = getattr(self, "_skybox_version", 0) + 1

    def _skybox_for(self, height: int, fov_deg: float) -> Optional[SkyboxCube]:
        """The mip level whose face edge best matches the viewport's
        angular resolution: a 90° cube face needs ≈ (π/2)·h / (2·tan(fov/2))
        texels to be minification-free; coarser viewports take coarser
        levels (smaller faces AND less shimmer)."""
        if self._skybox is None:
            return None
        chain = getattr(self, "_skybox_chain", None)
        if not chain or len(chain) == 1:
            return self._skybox
        import math

        ideal = (math.pi / 2.0) * height / max(
            2.0 * math.tan(math.radians(fov_deg) / 2.0), 1e-6)
        best = 0
        for lvl, faces in enumerate(chain):
            if faces.shape[1] >= ideal:
                best = lvl           # smallest level still ≥ ideal density
        return SkyboxCube(faces=chain[best], valid=jnp.asarray(True))

    def set_custom_shader(self, path: str) -> bool:
        """Install (or hot-swap) a user shading module — the pipeline-
        rebuild-on-GLSL-change analogue (render/shader_hook.py contract,
        reference Pipeline.cpp:997-1058). The next frame retraces with the
        new function; a failed load keeps the current shading live and
        returns False (see shader_hook.last_error)."""
        return self.shader_hook.load(path)

    def clear_custom_shader(self) -> None:
        """Back to the built-in Cook-Torrance PBR."""
        self.shader_hook.clear()

    def set_ai_frame(self, image: Optional[np.ndarray], blend: float) -> None:
        self._ai_image = None if image is None else jnp.asarray(image, jnp.float32)
        self.ai_blend = float(blend)
        self._ai_version = getattr(self, "_ai_version", 0) + 1

    # -- frame ------------------------------------------------------------------
    def _device_state(self):
        packed = self.geometry.packed()
        if self._device_geometry_version != self.geometry.version:
            self._device_geometry = geometry_to_device(packed)
            self._device_geometry_version = self.geometry.version
        return packed, self._device_geometry

    def _raster_mode(self) -> str:
        """"pallas" (the binned kernel) or "ref" (the oracle), chosen by
        platform unless RenderConfig.use_pallas asks (core.platform)."""
        return raster_mode(self.config.render.use_pallas)

    def _upscale_params(self):
        """Device-resident 2x super-resolution params, or None when
        ai_upscale is off. A checkpoint that fails to load raises: a frame
        asked to reconstruct must not silently render at native res."""
        if not self.config.render.ai_upscale:
            return None
        if self._upscaler_params is None:
            from trident.ai.upscaler import load_upscaler

            path = (self.config.ai.upscaler_path
                    or os.path.join("assets_out", "upscaler_2x"))
            params, _bc = load_upscaler(path)
            self._upscaler_params = jax.device_put(params)
            logger.info("ai_upscale: loaded %s", path)
        return self._upscaler_params

    def _banded_render_fn(self):
        """Jitted multi-chip banded frame function over the first
        `config.render.bands` devices (parallel.framebuffer)."""
        n = int(self.config.render.bands)
        devices = jax.devices()
        if len(devices) < n:
            raise ValueError(f"bands={n} but only {len(devices)} devices")
        if self._banded_jit is None or self._banded_n != n:
            from jax.sharding import Mesh

            from trident.parallel.framebuffer import (
                render_frame_banded_bundled)

            mesh = Mesh(np.asarray(devices[:n]), ("fb",))
            self._banded_mesh = mesh
            self._banded_jit = jax.jit(
                functools.partial(render_frame_banded_bundled, mesh, "fb"),
                static_argnames=(
                    "shape", "width", "height", "clear_color", "raster",
                    "skinned", "chunk", "sampling", "vertex_colors",
                    "plane_f16", "shadow_size",
                    "shadow_pcf", "supersample", "bloom", "bloom_threshold",
                    "bloom_strength", "shader_fn", "kcfg"))
            self._banded_n = n
        return self._banded_jit

    def _ensure_knobs(self) -> None:
        """Re-apply this renderer's kernel-knob set if another renderer
        (or a sweep) changed the globals since — keeps interleaved
        differently-configured renderers correct in one process."""
        if self._kcfg is None:
            return
        from trident.ops import kernel_knobs

        if kernel_knobs.trace_key() != self._kcfg:
            kernel_knobs.apply(self._kcfg_snapshot)

    def render_viewport(self, viewport_id: int = 0) -> FrameOutput:
        """Render one viewport; returns device FrameOutput (async)."""
        if self.registry is None:
            raise RuntimeError("no active registry — call set_active_registry")
        self._ensure_knobs()
        ctx = self.viewports[viewport_id]
        cam = self._camera_for(ctx)

        packed, device_geo = self._device_state()
        records = gather_mesh_draws(self.registry, self.geometry)
        from trident.ecs.components import SpriteComponent

        if any(True for _ in self.registry.view(SpriteComponent)):
            quad_idx = self.ensure_primitive(PrimitiveType.QUAD)
            packed, device_geo = self._device_state()  # quad may have been added
            records.extend(gather_sprite_draws(
                self.registry, self.geometry, quad_idx, self.time.elapsed,
                texture_lookup=self.textures.lookup))
        self.stats_models = len(records)
        self.stats_triangles = sum(
            packed.draw_infos[r.mesh_index].index_count // 3 for r in records)
        plan, tri_draw = self._plan_cache.plan(packed, records, self.geometry.version)
        self._last_records = records
        self._last_tri_draw = tri_draw
        params, palette, shade_table = build_draw_params(
            records, plan.num_draws, self.config.render.max_bones,
            material_table=self.geometry.material_table())
        skinned = any(r.bone_matrices is not None for r in records)
        lights = gather_lights(self.registry)
        textures = self.textures.device_arrays()
        # None compiles the clear-color-only background; with a file mip
        # chain loaded, pick the level matching this viewport's resolution
        skybox = self._skybox_for(ctx.height, getattr(cam, "fov_deg", 60.0))
        if not hasattr(self, "_ai_zero"):
            self._ai_zero = jnp.zeros((1, 1, 3), jnp.float32)
        if self._ai_image is not None and self.ai_blend > 0.0:
            ai_image, ai_blend = self._ai_image, float(self.ai_blend)
        else:
            ai_image, ai_blend = self._ai_zero, 0.0

        if self._vertex_colors_version != self.geometry.version:
            self._vertex_colors = bool((packed.colors != 1.0).any())
            self._vertex_colors_version = self.geometry.version

        # directional shadow pass (two-pass render graph)
        light_cam = None
        shadow_size = 0
        if self.config.render.shadows:
            from trident.ecs.components import LightComponent, LightType

            for _e, (lc,) in self.registry.view(LightComponent):
                if (lc.enabled and lc.light_type == LightType.DIRECTIONAL
                        and lc.cast_shadows):
                    from trident.ops.shadow import light_camera, scene_bounds

                    center, radius = scene_bounds(records, packed)
                    light_cam = light_camera(lc.direction, center, radius)
                    shadow_size = self.config.render.shadow_map_size
                    break

        rc = self.config.render
        banded = self._banded_render_fn() if rc.bands > 1 else None
        if banded is not None:
            # geometry first: do band heights work at all? Decide BEFORE
            # replicating anything onto the band mesh — a fallback to the
            # single-chip path must not receive mesh-committed arrays.
            n_bands = int(self.config.render.bands)
            ss = max(int(rc.supersample), 1)

            def _bands_ok(h):
                # render_frame_banded's contract: the bands split the
                # rows evenly, each a whole number of supersample units
                bh, rem = divmod(h * ss, n_bands)
                return rem == 0 and bh % ss == 0

            up = self._upscale_params()
            w_r, h_r = ctx.width, ctx.height
            if up is not None:
                # neural 2×: render the bands at half res, reconstruct on
                # the row-sharded frame (framebuffer.render_frame_banded).
                # Odd targets and half-heights that don't split evenly
                # into the bands fall back to native-res banding.
                if (ctx.width % 2 or ctx.height % 2
                        or not _bands_ok(ctx.height // 2)):
                    up = None
                else:
                    w_r, h_r = ctx.width // 2, ctx.height // 2
            if not _bands_ok(h_r):
                # indivisible band heights: degrade to the single-chip path
                # with a one-time warning rather than raising at draw time
                if not getattr(self, "_banded_indivisible_warned", False):
                    self._banded_indivisible_warned = True
                    logger.warning(
                        "bands=%d: height %d (supersample %d) does not split "
                        "evenly into the bands — rendering single-chip",
                        n_bands, h_r, ss)
                banded = None
        if banded is not None:
            # committed single-device arrays (device_put geometry/texture
            # caches, loaded upscaler params) conflict with the jitted
            # multi-device shard_map — replicate them onto the band mesh
            # (a no-op view once already placed there)
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as _P

            rep = NamedSharding(self._banded_mesh, _P())

            def _rep(t):
                return jax.tree.map(lambda x: jax.device_put(x, rep), t)

            device_geo = _rep(device_geo)
            textures = _rep(textures)
            skybox = _rep(skybox)
            ai_image = _rep(ai_image)
            corner_t = (None if skinned
                        else _rep(self._plan_cache.corner_table(packed)))
            if up is not None:
                up = _rep(up)
            prev = ctx.prev_state if up is not None else None
            # per-frame host state ships as the same TWO packed blobs the
            # single-chip interactive path uses (render/bundle.py) instead
            # of ~13 separate host uploads
            from trident.render.bundle import pack_frame

            f32b, i32b, bshape = pack_frame(
                params, palette, shade_table, cam.params(), lights,
                light_cam, ai_blend)
            out = banded(
                device_geo, plan, tri_draw, f32b, i32b, textures, skybox,
                ai_image, corner_t, up, prev,
                shape=bshape, width=w_r, height=h_r,
                clear_color=tuple(rc.clear_color),
                raster=self._raster_mode(), chunk=64, skinned=skinned,
                sampling=rc.sampling, vertex_colors=self._vertex_colors,
                plane_f16=rc.plane_f16,
                shadow_size=shadow_size,
                shadow_pcf=rc.shadow_pcf,
                supersample=max(int(rc.supersample), 1),
                bloom=rc.bloom, bloom_threshold=rc.bloom_threshold,
                bloom_strength=rc.bloom_strength, kcfg=self._kcfg,
                shader_fn=self.shader_hook.fn)
            if up is not None:
                hp = jax.lax.Precision.HIGHEST
                p = cam.params()
                hist = out.history if out.history is not None else out.color
                ctx.prev_state = (hist,
                                  jnp.matmul(p.proj, p.view, precision=hp))
            # the idle-frame signature describes the SINGLE-chip pipeline;
            # a frame produced here (possibly via a banding fallback with
            # different upscale behavior) must not satisfy a later
            # single-chip sig match
            ctx.last_sig = None
        else:
            from trident.render.bundle import pack_frame

            f32, i32, shape = pack_frame(params, palette, shade_table,
                                         cam.params(), lights, light_cam,
                                         ai_blend)
            corner_t = (None if skinned
                        else self._plan_cache.corner_table(packed))
            up = self._upscale_params()
            w_r, h_r = ctx.width, ctx.height
            if up is not None:
                if ctx.width % 2 or ctx.height % 2:
                    up = None      # odd target: reconstruction can't hit it
                else:
                    w_r, h_r = ctx.width // 2, ctx.height // 2
            # idle-frame cache: if EVERY input is byte-identical to the
            # previous frame of this viewport, skip the dispatch and
            # reuse the output (what an editor does while nothing moves)
            sig = (f32.tobytes(), i32.tobytes(), shape, w_r, h_r,
                   self.geometry.version, self.textures.version,
                   getattr(self, "_skybox_version", 0),
                   # monotone versions, NOT id()s: CPython recycles ids of
                   # freed objects, which could hand a new AI frame or plan
                   # a stale cache hit
                   (getattr(self, "_ai_version", 0)
                    if ai_image is not self._ai_zero else -1),
                   self._plan_cache.version,
                   skinned, shadow_size, self._vertex_colors,
                   up is not None, self._raster_mode(),
                   rc.sampling, rc.plane_f16,
                   rc.shadow_pcf, int(rc.supersample), rc.bloom,
                   rc.bloom_threshold, rc.bloom_strength,
                   tuple(rc.clear_color), self.shader_hook.version,
                   self._kcfg)
            if ctx.last_frame is not None and ctx.last_sig == sig:
                return ctx.last_frame
            ctx.last_sig = sig
            prev = ctx.prev_state if up is not None else None
            out = render_frame_bundled(
                device_geo, plan, tri_draw, f32, i32, textures, skybox,
                ai_image, corner_t, up, prev, shape=shape,
                width=w_r, height=h_r,
                clear_color=tuple(rc.clear_color),
                raster=self._raster_mode(), chunk=64, skinned=skinned,
                sampling=rc.sampling,
                vertex_colors=self._vertex_colors,
                plane_f16=rc.plane_f16,
                shadow_size=shadow_size,
                shadow_pcf=rc.shadow_pcf,
                supersample=max(int(rc.supersample), 1),
                bloom=rc.bloom,
                bloom_threshold=rc.bloom_threshold,
                bloom_strength=rc.bloom_strength,
                shader_fn=self.shader_hook.fn, kcfg=self._kcfg,
                **self._stride_kwargs(skinned))
            if up is not None:
                hp = jax.lax.Precision.HIGHEST
                p = cam.params()
                hist = out.history if out.history is not None else out.color
                ctx.prev_state = (hist,
                                  jnp.matmul(p.proj, p.view, precision=hp))
        ctx.last_frame = out
        return out

    def _stride_kwargs(self, skinned: bool) -> dict:
        """Static draw_stride/real_draws kwargs for the uniform-instancing
        broadcast path (ops/corner.py). Gated to ≥64k-triangle plans: the
        values are jit statics, so small editor scenes (where the (T,48)
        gather is cheap anyway) keep shape-stable recompile behavior when
        entities spawn."""
        stride, nd = self._plan_cache.draw_stride, self._plan_cache.real_draws
        if skinned or not stride or stride * nd < 65536:
            return {"draw_stride": 0, "real_draws": 0}
        return {"draw_stride": stride, "real_draws": nd}

    def draw_frame(self) -> FrameOutput:
        """Render all viewports (active last), with frames-in-flight pacing
        and frame timing accumulation — the DrawFrame analogue."""
        dt = self.time.tick()
        for vid in sorted(self.viewports):
            if vid != self.active_viewport:
                self.render_viewport(vid)
        out = self.render_viewport(self.active_viewport)

        # pacing: bound outstanding async frames (fences → block_until_ready)
        self._inflight.append(out)
        if len(self._inflight) > self.max_inflight:
            old = self._inflight.pop(0)
            jax.block_until_ready(old.color)

        ctx = self.viewports[self.active_viewport]
        self.timing.accumulate(dt * 1000.0, (ctx.width, ctx.height))
        return out

    def read_frame(self, out: Optional[FrameOutput] = None,
                   viewport_id: Optional[int] = None) -> np.ndarray:
        """Render (unless given a FrameOutput) and read back (H,W,4) uint8 —
        the GPU→CPU staging analogue."""
        if out is None:
            vid = self.active_viewport if viewport_id is None else viewport_id
            out = self.render_viewport(vid)
        frame = np.asarray(jax.block_until_ready(out.color))
        if out.aux is not None and self.config.render.raster_drop_checks:
            aux = np.asarray(out.aux).reshape(-1, 2).sum(axis=0)
            if aux[0] or aux[1]:
                logger.warning(
                    "raster capacity overflow: %d pairs truncated, %d big "
                    "chunks dropped — geometry is missing; render in bands "
                    "(RenderConfig.bands) or reduce resolution/triangles",
                    int(aux[0]), int(aux[1]))
        return frame

    def _tri_map_entity(self, tri_map: np.ndarray, x: int, y: int,
                        ctx: "ViewportContext") -> Optional[int]:
        """Shared picking core: winner-triangle map + draw plan → entity.
        The SINGLE implementation of the rescale and bounds guards (pick
        and pick_entity previously drifted apart here): tri ids from a
        stale frame can exceed the CURRENT tri_draw after the plan
        shrinks, and tri_id may be at a different resolution than the
        viewport (supersampling larger, ai_upscale smaller)."""
        if self._last_tri_draw is None or not self._last_records:
            return None
        ty = int(np.clip(y * tri_map.shape[0] // max(ctx.height, 1),
                         0, tri_map.shape[0] - 1))
        tx = int(np.clip(x * tri_map.shape[1] // max(ctx.width, 1),
                         0, tri_map.shape[1] - 1))
        tri = int(tri_map[ty, tx])
        if tri < 0 or tri >= int(self._last_tri_draw.shape[0]):
            return None
        draw = int(np.asarray(self._last_tri_draw)[tri])
        if draw < 0 or draw >= len(self._last_records):
            return None
        return int(self._last_records[draw].entity)

    def pick_entity(self, x: int, y: int,
                    viewport_id: Optional[int] = None) -> Optional[int]:
        """Entity under the pixel (viewport coordinates) or None — the
        ImGuizmo-selection analogue (SceneViewportPanel.cpp:63-100): the
        frame's winner-triangle id maps through the draw plan back to the
        ECS entity that issued the draw."""
        vid = self.active_viewport if viewport_id is None else viewport_id
        out = self.render_viewport(vid)
        return self._tri_map_entity(np.asarray(out.tri_id), x, y,
                                    self.viewports[vid])

    # -- text overlay + presentation (TextRenderer analogue) --------------------
    @property
    def text(self):
        if not hasattr(self, "_text_overlay"):
            from trident.io.text_overlay import TextOverlay

            self._text_overlay = TextOverlay()
        return self._text_overlay

    def queue_text(self, viewport_id: int, text: str, x: int, y: int,
                   color=(1.0, 1.0, 1.0, 1.0), size: int = 16) -> None:
        self.text.queue_text(viewport_id, text, x, y, color, size)

    def present(self, viewport_id: Optional[int] = None) -> np.ndarray:
        """Read back the viewport and composite its queued text — what a
        frontend blits to the screen."""
        vid = self.active_viewport if viewport_id is None else viewport_id
        frame = self.read_frame(viewport_id=vid)
        ctx = self.viewports[vid]
        overlay = self.text.render_overlay(vid, ctx.width, ctx.height)
        if overlay is not None:
            from trident.io.text_overlay import composite_overlay

            frame = composite_overlay(frame, overlay)
            # draw-list semantics: a presented queue is consumed — callers
            # re-queue each frame (nothing in production calls
            # begin_frame, so without this the overlay accumulated every
            # string ever queued and re-rasterized them all forever)
            self.text.clear_viewport(vid)
        return frame

    def pick(self, x: int, y: int, viewport_id: Optional[int] = None) -> int:
        """Entity under pixel (x,y) of the LAST rendered frame (no
        re-render), or -1 — the viewport click-select (ImGuizmo/
        SceneViewport analogue). Uses the winner-triangle GBuffer, so it
        is exact per pixel."""
        vid = self.active_viewport if viewport_id is None else viewport_id
        ctx = self.viewports.get(vid)
        if ctx is None or ctx.last_frame is None:
            return -1
        if not (0 <= y < ctx.height and 0 <= x < ctx.width):
            return -1
        ent = self._tri_map_entity(np.asarray(ctx.last_frame.tri_id),
                                   x, y, ctx)
        return -1 if ent is None else ent

    def bind_runtime_camera(self, registry: Registry) -> bool:
        """Find the primary CameraComponent and drive the runtime camera
        from it (RefreshRuntimeCameraBinding, Renderer.cpp:4545-4574)."""
        from trident.ecs.components import CameraComponent, TransformComponent

        primary = None
        fallback = None
        for entity, (cam,) in registry.view(CameraComponent):
            if fallback is None:
                fallback = (entity, cam)
            if cam.primary:
                primary = (entity, cam)  # last primary wins: user cameras
                                         # override the seeded default
        primary = primary or fallback
        if primary is None:
            self.runtime_camera_ready = False
            return False
        entity, cam = primary
        transform = registry.try_get(entity, TransformComponent)
        if transform is None:
            transform = TransformComponent()
        self.runtime_camera.bind(transform, cam)
        self.runtime_camera_ready = True
        return True
