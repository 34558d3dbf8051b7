"""Multi-chip dry-run: the full interpolation-net training step jitted over
a (dp, tp) mesh with real shardings, one step on tiny shapes — plus the
same step through the EXPLICIT-collective path (shard_map + pmean grads +
cross-device BatchNorm), and the banded SPMD renderer on the production
Pallas kernels with shadows on.

Run by the driver under a virtual CPU mesh
(--xla_force_host_platform_device_count=N) to validate the SPMD paths
compile and execute without N physical chips.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map  # jax >= 0.7 public API
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from trident.ai.train import TrainConfig, create_state, train_step
from trident.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_sharding,
    replicated,
)


def run_dryrun(n_devices: int, resolution=(32, 32), batch_per_device: int = 1,
               base_channels: int = 8, include_render: bool = True) -> None:
    """`include_render=False` skips the banded-render phases (the
    interpret-mode graphs cost minutes of CPU compile each): the test
    suite covers them directly in test_parallel's banded-vs-single parity
    tests, and the driver runs THIS full dryrun (render included) on the
    8-device virtual mesh every round."""
    devices = jax.devices()
    if len(devices) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(devices)} "
            f"(set XLA_FLAGS=--xla_force_host_platform_device_count={n_devices})")
    mesh = make_mesh(n_devices)
    dp = mesh.shape["dp"]

    config = TrainConfig(resolution=resolution, base_channels=base_channels,
                         batch_size=dp * batch_per_device)
    state = create_state(config)

    # placement: params/optimizer channel-sharded over tp, stats likewise,
    # batch sharded over dp
    p_shard = param_sharding(mesh, state.params)
    bs_shard = param_sharding(mesh, state.batch_stats)
    opt_shard = jax.tree.map(
        lambda leaf: param_sharding(mesh, leaf) if isinstance(leaf, dict) else replicated(mesh),
        state.opt_state, is_leaf=lambda x: isinstance(x, dict))

    state = state.replace(
        params=jax.device_put(state.params, p_shard),
        batch_stats=jax.device_put(state.batch_stats, bs_shard),
        opt_state=jax.tree.map(jax.device_put, state.opt_state,
                               jax.tree.map(lambda _: replicated(mesh), state.opt_state)),
    )

    b = config.batch_size
    h, w = resolution
    rng = np.random.default_rng(0)
    inputs_np = rng.random((b, h, w, 6), np.float32)
    targets_np = rng.random((b, h, w, 3), np.float32)
    inputs = jax.device_put(inputs_np, batch_sharding(mesh, 4))
    targets = jax.device_put(targets_np, batch_sharding(mesh, 4))

    step = jax.jit(train_step, static_argnames=("axis_name",))
    with mesh:
        new_state, loss, out = step(state, inputs, targets, axis_name=None)
        jax.block_until_ready(loss)

    assert np.isfinite(float(loss)), f"non-finite loss {loss}"
    assert out.shape == (b, h, w, 3)
    print(f"dryrun_multichip OK: mesh={dict(mesh.shape)} loss={float(loss):.4f} "
          f"out={out.shape}")

    _dryrun_explicit_collectives(n_devices, inputs_np, targets_np,
                                 config, float(loss))
    if include_render:
        _dryrun_banded_render(n_devices)


def _dryrun_explicit_collectives(n_devices: int, inputs_np, targets_np,
                                 config: TrainConfig,
                                 gspmd_loss: float) -> None:
    """The OTHER branch of train_step: shard_map over a 1-D dp mesh with
    axis_name='dp' (explicit pmean of grads/loss) and cross-device
    BatchNorm moments (bn_axis_name). Asserts loss parity with the GSPMD
    step on the same data."""
    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("dp",))
    state = create_state(config, bn_axis_name="dp")

    # tile the batch up to the 1-D mesh size: EVENLY duplicated samples
    # leave the mean loss and the BatchNorm moments unchanged, so parity
    # still holds (batch = dp·k and dp divides n, so this is always even)
    batch = inputs_np.shape[0]
    if batch % n_devices != 0:
        # tile to lcm(batch, n_devices): even duplication of every sample,
        # so loss/BN parity still holds for any batch/device combination
        reps = int(np.lcm(batch, n_devices)) // batch
        inputs_np = np.tile(inputs_np, (reps, 1, 1, 1))
        targets_np = np.tile(targets_np, (reps, 1, 1, 1))
    if inputs_np.shape[0] % n_devices != 0:
        raise ValueError(
            f"batch {inputs_np.shape[0]} is not divisible by n_devices "
            f"{n_devices} even after lcm tiling — this should be impossible")

    step = shard_map(
        functools.partial(train_step, axis_name="dp"),
        mesh=mesh,
        in_specs=(P(), P("dp"), P("dp")),
        out_specs=(P(), P(), P("dp")),
        check_vma=False)
    new_state, loss, out = jax.jit(step)(
        state, jnp.asarray(inputs_np), jnp.asarray(targets_np))
    jax.block_until_ready(loss)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite shard_map loss {loss}"
    assert abs(loss - gspmd_loss) < 1e-4, (
        f"explicit-collective loss {loss:.6f} != GSPMD loss "
        f"{gspmd_loss:.6f}")
    # the synced-BN stats must have actually mutated and stayed replicated
    stats0 = jax.tree.leaves(new_state.batch_stats)
    assert stats0 and all(np.isfinite(np.asarray(s)).all() for s in stats0)
    print(f"dryrun explicit collectives OK: dp={n_devices} loss={loss:.4f} "
          f"(GSPMD {gspmd_loss:.4f})")


def _dryrun_banded_render(n_devices: int, size: int = 64) -> None:
    """Exercise the SPMD renderer on the PRODUCTION path: Pallas visibility
    + in-kernel forward resolve (interpret mode on CPU), directional
    shadows, framebuffer bands over a 1-D mesh with the geometry phase
    sharded (parallel/framebuffer.py)."""
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.components import (
        LightComponent, LightType, MeshComponent, TransformComponent)
    from trident.ecs.registry import Registry
    from trident.geometry.primitives import PrimitiveType
    from trident.ops.shadow import light_camera, scene_bounds
    from trident.parallel.framebuffer import render_frame_banded
    from trident.render.frame import (
        build_draw_params, build_draw_plan, gather_mesh_draws, geometry_to_device,
    )
    from trident.render.lights import gather_lights
    from trident.render.renderer import Renderer
    from trident.render.types import AiBlend, SkyboxCube

    # keep every band at least one raster tile row tall
    from trident.ops.raster import TILE_H

    size = max(size, n_devices * TILE_H)
    r = Renderer(EngineConfig(render=RenderConfig(width=size, height=size)))
    reg = Registry()
    r.set_active_registry(reg)
    e = reg.create()
    reg.add(e, TransformComponent())
    reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(light_type=LightType.DIRECTIONAL,
                                direction=np.array([-0.4, -1.0, -0.3], np.float32),
                                cast_shadows=True))
    r.editor_camera.set_position([0, 0, 3])
    r.editor_camera.look_at_target([0, 0, 0])

    packed = r.geometry.packed()
    geo = geometry_to_device(packed)
    records = gather_mesh_draws(reg, r.geometry)
    plan, tri_draw = build_draw_plan(packed, records)
    params, palette, shade = build_draw_params(
        records, plan.num_draws, material_table=r.geometry.material_table())
    lights = gather_lights(reg)
    tex = r.textures.device_arrays()
    sky = SkyboxCube(faces=jnp.zeros((6, 1, 1, 3), jnp.float32),
                     valid=jnp.asarray(False))
    ai = AiBlend(image=jnp.zeros((1, 1, 3), jnp.float32),
                 blend=jnp.asarray(0.0, jnp.float32))
    center, radius = scene_bounds(records, packed)
    light_cam = light_camera(np.array([-0.4, -1.0, -0.3], np.float32),
                             center, radius)

    fb_mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("fb",))
    # jitted: eager dispatch of the interpret-mode kernels costs minutes,
    # the jitted graph compiles in seconds (and persists in the cache)
    out = jax.jit(functools.partial(
        render_frame_banded, fb_mesh, "fb",
        width=size, height=size, clear_color=(0.05, 0.05, 0.08, 1.0),
        raster="pallas", skinned=False,
        shadow_size=size, shadow_pcf=True))(
        geo, plan, tri_draw, params, palette, shade,
        r.editor_camera.params(), lights, tex, sky, ai, light_cam)
    color = np.asarray(out.color)
    assert color.shape == (size, size, 4)
    covered = int((np.asarray(out.tri_id) >= 0).sum())
    assert covered > 0, "banded render drew nothing"
    aux = np.asarray(out.aux).reshape(-1, 2).sum(axis=0)
    assert aux[0] == 0 and aux[1] == 0, f"banded raster dropped work: {aux}"
    print(f"dryrun banded render OK: {n_devices} bands (pallas+shadows), "
          f"covered px={covered}")

    # the PRODUCTION interactive multi-chip path ships per-frame state as
    # TWO packed blobs (render_frame_banded_bundled; shadow bias arrives
    # traced through the shard_map) — it must produce the identical frame
    from trident.parallel.framebuffer import render_frame_banded_bundled
    from trident.render.bundle import pack_frame

    f32b, i32b, bshape = pack_frame(params, np.asarray(palette),
                                    np.asarray(shade),
                                    r.editor_camera.params(), lights,
                                    light_cam, 0.0)
    out_b = jax.jit(functools.partial(
        render_frame_banded_bundled, fb_mesh, "fb",
        shape=bshape, width=size, height=size,
        clear_color=(0.05, 0.05, 0.08, 1.0),
        raster="pallas", skinned=False,
        shadow_size=size, shadow_pcf=True))(
        geo, plan, tri_draw, f32b, i32b, tex, sky, ai.image)
    if not np.array_equal(np.asarray(out_b.color), color):
        # shadow_bias is a jit STATIC float in the unbundled call above
        # but traced from the blob here — allow only that 1-ulp class
        diff = np.abs(np.asarray(out_b.color).astype(int) - color.astype(int))
        assert diff.max() <= 1, f"bundled banded diverges: max {diff.max()}"
    print(f"dryrun bundled banded OK: {n_devices} bands, 2-blob uploads")

    # neural 2× on bands: half-res banded render + reconstruction on the
    # row-sharded frame (GSPMD halo-exchanged convs); zero-init net = the
    # bilinear baseline, so the output must stay a valid full-size frame
    from trident.ai.upscaler import init_upscaler

    _, variables = init_upscaler(jax.random.PRNGKey(0), base_channels=8)
    up = jax.device_get(variables["params"])
    nb = min(2, n_devices)            # one tile row per half-res band
    half = nb * TILE_H
    mesh_up = Mesh(np.asarray(jax.devices()[:nb]), ("fb",))
    out_up = jax.jit(functools.partial(
        render_frame_banded, mesh_up, "fb",
        width=half, height=half, clear_color=(0.05, 0.05, 0.08, 1.0),
        raster="pallas", skinned=False))(
        geo, plan, tri_draw, params, palette, shade,
        r.editor_camera.params(), lights, tex, sky, ai,
        upscale_params=up)
    assert np.asarray(out_up.color).shape == (half * 2, half * 2, 4)
    assert int((np.asarray(out_up.tri_id) >= 0).sum()) > 0
    print(f"dryrun banded ai_upscale OK: {half}->{half * 2} over "
          f"{nb} bands")
