"""Fragment shading: Cook-Torrance PBR, texturing, tonemap, skybox, AI blend.

Math is an exact port of the reference's GLSL (Default.frag):
  * GGX normal distribution, Smith geometry with k=(r+1)^2/8, Schlick Fresnel
  * 1 directional + up to 8 point lights, squared edge-falloff attenuation
  * roughness clamped to [0.045, 1], F0 = mix(0.04, albedo, metallic)
  * ambient = ambient_color*intensity * albedo * ambient_strength
  * Reinhard tonemap + gamma 2.2
  * optional AI-frame blend as a final mix (Default.frag:182-191)

Everything is elementwise over (...,3) arrays: the same functions shade the
deferred full-frame pass AND run inside Pallas kernel bodies (jnp ops lower
to VPU code in both contexts).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from trident.render.types import LightParams

Array = jax.Array
PI = 3.14159265359


def _dot(a: Array, b: Array) -> Array:
    return jnp.sum(a * b, axis=-1, keepdims=True)


def _normalize(v: Array, eps: float = 1e-8) -> Array:
    return v * jax.lax.rsqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))


def distribution_ggx(n: Array, h: Array, roughness: Array) -> Array:
    a = roughness * roughness
    a2 = a * a
    ndoth = jnp.maximum(_dot(n, h), 0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def geometry_schlick_ggx(ndotv: Array, roughness: Array) -> Array:
    r = roughness + 1.0
    k = (r * r) / 8.0
    denom = ndotv * (1.0 - k) + k
    return ndotv / jnp.maximum(denom, 1e-4)


def geometry_smith(n: Array, v: Array, l: Array, roughness: Array) -> Array:
    ndotv = jnp.maximum(_dot(n, v), 0.0)
    ndotl = jnp.maximum(_dot(n, l), 0.0)
    return geometry_schlick_ggx(ndotv, roughness) * geometry_schlick_ggx(ndotl, roughness)


def fresnel_schlick(cos_theta: Array, f0: Array) -> Array:
    return f0 + (1.0 - f0) * jnp.power(jnp.clip(1.0 - cos_theta, 0.0, 1.0), 5.0)


def evaluate_pbr_light(light_dir: Array, radiance: Array, normal: Array,
                       view_dir: Array, albedo: Array, metallic: Array,
                       roughness: Array, f0: Array) -> Array:
    """One light's contribution (Default.frag EvaluatePBRLighting)."""
    h = _normalize(view_dir + light_dir)
    ndf = distribution_ggx(normal, h, roughness)
    geom = geometry_smith(normal, view_dir, light_dir, roughness)
    fresnel = fresnel_schlick(jnp.maximum(_dot(h, view_dir), 0.0), f0)
    numerator = ndf * geom * fresnel
    denominator = jnp.maximum(
        4.0 * jnp.maximum(_dot(normal, view_dir), 0.0) * jnp.maximum(_dot(normal, light_dir), 0.0),
        1e-4,
    )
    specular = numerator / denominator
    ks = fresnel
    kd = (1.0 - ks) * (1.0 - metallic)
    ndotl = jnp.maximum(_dot(normal, light_dir), 0.0)
    return (kd * albedo / PI + specular) * radiance * ndotl


def shade_pbr(world: Array, normal: Array, albedo: Array, metallic: Array,
              roughness: Array, ambient_strength: Array, camera_pos: Array,
              lights: LightParams, dir_shadow: Array = None) -> Array:
    """Full lighting sum → linear HDR color. Shapes: world/normal/albedo
    (...,3); metallic/roughness/ambient_strength (...,1). `dir_shadow`
    (...,1) multiplies the directional light (shadow mapping)."""
    metallic = jnp.clip(metallic, 0.0, 1.0)
    roughness = jnp.clip(roughness, 0.045, 1.0)
    ambient_strength = jnp.clip(ambient_strength, 0.0, 1.0)

    view_dir = _normalize(camera_pos - world)
    f0 = 0.04 * (1.0 - metallic) + albedo * metallic

    direct = jnp.zeros_like(albedo)

    # directional light
    dir_on = (lights.dir_count > 0).astype(albedo.dtype)
    l_dir = _normalize(-lights.dir_direction)
    l_dir = jnp.broadcast_to(l_dir, world.shape)
    radiance = lights.dir_color[:3] * lights.dir_color[3]
    dir_term = dir_on * evaluate_pbr_light(
        l_dir, radiance, normal, view_dir, albedo, metallic, roughness, f0)
    if dir_shadow is not None:
        dir_term = dir_term * dir_shadow
    direct += dir_term

    # point lights — static loop over the (bucketed) slots present in the
    # LightParams arrays, masked by point_count; scenes without point
    # lights pass zero-row arrays and skip all of this at trace time
    max_points = lights.point_pos_range.shape[0]
    for i in range(max_points):
        on = (i < lights.point_count).astype(albedo.dtype)
        to_light = lights.point_pos_range[i, :3] - world
        dist = jnp.sqrt(jnp.maximum(jnp.sum(to_light * to_light, axis=-1, keepdims=True), 1e-12))
        near_zero = dist <= 1e-4
        l_vec = to_light / jnp.where(near_zero, 1.0, dist)
        radius = jnp.maximum(lights.point_pos_range[i, 3], 1e-4)
        norm_dist = jnp.clip(dist / radius, 0.0, 1.0)
        atten = (1.0 - norm_dist) ** 2
        radiance = (lights.point_color_intensity[i, :3]
                    * lights.point_color_intensity[i, 3] * atten)
        contrib = evaluate_pbr_light(
            l_vec, radiance, normal, view_dir, albedo, metallic, roughness, f0)
        direct += on * jnp.where(near_zero, 0.0, contrib)

    ambient = lights.ambient[:3] * lights.ambient[3] * albedo * ambient_strength
    return ambient + direct


def tonemap_reinhard_gamma(color: Array) -> Array:
    """color/(color+1) then gamma 1/2.2 (Default.frag:176-178)."""
    c = color / (color + 1.0)
    return jnp.power(jnp.maximum(c, 0.0), 1.0 / 2.2)


# -- texture sampling ---------------------------------------------------------
#
# Textures live in per-slot flat mip pyramids packed into one buffer
# (render.types.TextureArrays): entry(s,l,y,x) = quads[slot_base
# + level_base(E_s,l) + y*((E_s>>l)+1) + x] holding the 2×2 block.
# Bilinear = ONE quad-gather, nearest = 1, trilinear = 2.

def _unpack_rgba8(v: Array) -> Array:
    return jnp.stack([
        (v & 0xFF).astype(jnp.float32),
        ((v >> 8) & 0xFF).astype(jnp.float32),
        ((v >> 16) & 0xFF).astype(jnp.float32),
        ((v >> 24) & 0xFF).astype(jnp.float32),
    ], axis=-1)


def _level_geom(tex, slot: Array, level: Array, size_hint=None):
    """(lw, lh, stride, base) for per-pixel integer mip levels. Level
    tiles are (e+1)×(e+1) with wrap-gutter column AND row, so
    stride = (E_s>>l) + 1.

    Per-pixel table gathers are the shading cost driver, so everything here
    is CLOSED FORM: a slot's level offset for its pow2 edge E is exactly
    Σ_{j<l}((E>>j)+1)² = (E²−(E>>l)²)·4/3 + 4(E−(E>>l)) + l (4^l−1 and
    2^l−1 divisibility make it exact in integers). `size_hint` is the
    per-pixel (w0, h0, base>>8, edge) row when the caller already has it
    (the resolve kernel bakes it into the attribute image; the plane-gather
    path reuses its mip-math gather) — without it, ONE sizes-row gather."""
    if size_hint is None:
        row = tex.sizes[slot]
        w0, h0 = row[..., 0], row[..., 1]
        base8, edge = row[..., 2], row[..., 3]
    else:
        w0, h0, base8, edge = size_hint
    lw = jnp.maximum(jnp.right_shift(w0, level), 1)
    lh = jnp.maximum(jnp.right_shift(h0, level), 1)
    es = jnp.maximum(jnp.right_shift(edge, level), 1)
    stride = es + 1
    # clamp the additive level term to the slot's OWN pyramid depth: `level`
    # is only clipped to the GLOBAL max level upstream, so a small slot
    # minified past its own tail must not walk into the alignment padding /
    # next slot. edge is pow2, so log2 via f32 is exact (edge ≤ 2^23).
    tail = jnp.log2(jnp.maximum(edge, 1).astype(jnp.float32)).astype(level.dtype)
    base = ((base8 << 8)
            + (edge * edge - es * es) * 4 // 3 + (edge - es) * 4
            + jnp.minimum(level, tail))
    return lw, lh, stride, base


def bilinear_index(tex, slot: Array, uv: Array, level: Array,
                   size_hint=None):
    """(idx, fx, fy) of the REPEAT-wrap bilinear quad fetch at integer mip
    `level` — the index math of _bilinear_flat."""
    lw, lh, stride, base = _level_geom(tex, slot, level, size_hint)

    x = uv[..., 0] * lw.astype(jnp.float32) - 0.5
    y = uv[..., 1] * lh.astype(jnp.float32) - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0

    def wrap(v, n):
        return jnp.mod(v.astype(jnp.int32), n)

    x0i = wrap(x0, lw)
    y0i = wrap(y0, lh)
    return base + y0i * stride + x0i, fx, fy


def _bilinear_flat(tex, slot: Array, uv: Array, level: Array,
                   size_hint=None) -> Array:
    """Bilinear sample with REPEAT wrap at integer mip `level` (per-pixel).

    ONE 16-byte quad-gather: quads[i] = the (x,y)…(x+1,y+1) block, and the
    gutter column/row make the +1 neighbors valid at the wrap seam.
    Returns (...,4) f32 in [0,1].
    """
    idx, fx, fy = bilinear_index(tex, slot, uv, level, size_hint)
    fx = fx[..., None]
    fy = fy[..., None]

    q = tex.quads[idx]                                  # (...,4) u32
    t00, t10 = _unpack_rgba8(q[..., 0]), _unpack_rgba8(q[..., 1])
    t01, t11 = _unpack_rgba8(q[..., 2]), _unpack_rgba8(q[..., 3])
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return (top * (1.0 - fy) + bot * fy) * (1.0 / 255.0)


def sample_bilinear(tex, slot: Array, uv: Array) -> Array:
    """Bilinear sample at mip 0."""
    return _bilinear_flat(tex, slot, uv, jnp.zeros(uv.shape[:-1], jnp.int32))


def _nearest_flat(tex, slot: Array, uv: Array, level: Array,
                  size_hint=None) -> Array:
    """Nearest-texel sample at integer mip `level` — ONE gather."""
    lw, lh, stride, base = _level_geom(tex, slot, level, size_hint)
    xi = jnp.mod(jnp.floor(uv[..., 0] * lw.astype(jnp.float32)).astype(jnp.int32), lw)
    yi = jnp.mod(jnp.floor(uv[..., 1] * lh.astype(jnp.float32)).astype(jnp.int32), lh)
    v = tex.quads[base + yi * stride + xi, 0]
    return _unpack_rgba8(v) * (1.0 / 255.0)


def sample_texture_mip(tex, slot: Array, uv: Array, mip_level: Array,
                       size_hint=None) -> Array:
    """Trilinear sample: bilinear at floor/ceil mip, lerped. 2 quad-gathers.
    Levels past a slot's own pyramid clamp to its 1×1 tail in _level_geom."""
    mip = jnp.clip(mip_level, 0.0, tex.max_level.astype(jnp.float32))
    lo = jnp.floor(mip)
    frac = (mip - lo)[..., None]
    lo_i = lo.astype(jnp.int32)
    lo_samp = _bilinear_flat(tex, slot, uv, lo_i, size_hint)
    hi_samp = _bilinear_flat(tex, slot, uv, lo_i + 1, size_hint)
    return lo_samp * (1.0 - frac) + hi_samp * frac


def sample_texture(tex, slot: Array, uv: Array, mip_level: Array,
                   mode: str = "bilinear", size_hint=None) -> Array:
    """Sampling quality knob: per-pixel gathers are the cost driver.
    nearest = 1 quad-gather, bilinear = 1 (at the rounded mip), trilinear
    = 2. `size_hint` = per-pixel (w0, h0, base>>8, edge) i32 rows to skip
    the sizes gather (see _level_geom)."""
    mip = jnp.clip(mip_level, 0.0, tex.max_level.astype(jnp.float32))
    if mode == "trilinear":
        return sample_texture_mip(tex, slot, uv, mip, size_hint)
    mip_i = jnp.round(mip).astype(jnp.int32)
    if mode == "nearest":
        return _nearest_flat(tex, slot, uv, mip_i, size_hint)
    return _bilinear_flat(tex, slot, uv, mip_i, size_hint)


def sample_skybox(faces: Array, direction: Array,
                  bilinear: bool = True) -> Array:
    """Cubemap sample by direction. faces: (6,E,E,3) f32 ordered
    +x,-x,+y,-y,+z,-z (Vulkan cube face order); direction: (...,3).
    Bilinear (4 gathers, clamp-to-edge within the face — the reference's
    VK_FILTER_LINEAR cubemap sampler) by default; nearest = 1 gather."""
    d = _normalize(direction)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)

    # face selection per the cubemap spec
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = jnp.where(
        is_x, jnp.where(x > 0, 0, 1),
        jnp.where(is_y, jnp.where(y > 0, 2, 3), jnp.where(z > 0, 4, 5)),
    ).astype(jnp.int32)

    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az))
    ma = jnp.maximum(ma, 1e-8)
    # (sc,tc) per face, standard cube-map convention
    sc = jnp.where(is_x, jnp.where(x > 0, -z, z),
                   jnp.where(is_y, x, jnp.where(z > 0, x, -x)))
    tc = jnp.where(is_y, jnp.where(y > 0, z, -z), -y)
    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5

    e = faces.shape[1]
    if not bilinear:
        xi = jnp.clip((u * e).astype(jnp.int32), 0, e - 1)
        yi = jnp.clip((v * e).astype(jnp.int32), 0, e - 1)
        return faces[face, yi, xi]

    fx = u * e - 0.5
    fy = v * e - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, e - 1)
    x1i = jnp.clip(x0.astype(jnp.int32) + 1, 0, e - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, e - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, e - 1)
    top = faces[face, y0i, x0i] * (1.0 - wx) + faces[face, y0i, x1i] * wx
    bot = faces[face, y1i, x0i] * (1.0 - wx) + faces[face, y1i, x1i] * wx
    return top * (1.0 - wy) + bot * wy
