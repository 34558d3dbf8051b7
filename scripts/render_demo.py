#!/usr/bin/env python
"""Headless render driver: load assets or spawn primitives, orbit the
camera, write PNG frames and optionally a video — the editor-less
equivalent of flying around in Trident-Forge.

Examples:
  python scripts/render_demo.py --out /tmp/demo --frames 8
  python scripts/render_demo.py --model Assets/teapot.obj --video /tmp/d.y4m \\
      --width 1280 --height 720 --shadows --bloom
  python scripts/render_demo.py --scene saved.trident --ai-checkpoint ckpt/
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", action="append", default=[],
                        help="OBJ/glTF/GLB to import (repeatable)")
    parser.add_argument("--scene", default=None, help=".trident scene to load")
    parser.add_argument("--out", default="demo_frames", help="PNG output dir")
    parser.add_argument("--video", default=None, help="also record .y4m/.mp4")
    parser.add_argument("--frames", type=int, default=12)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--orbit-degrees", type=float, default=360.0)
    parser.add_argument("--shadows", action="store_true")
    parser.add_argument("--pcf", action="store_true",
                        help="soft shadow edges (2x2 bilinear PCF)")
    parser.add_argument("--bloom", action="store_true")
    parser.add_argument("--supersample", type=int, default=1)
    parser.add_argument("--sampling", default="bilinear",
                        choices=["nearest", "bilinear", "trilinear"])
    parser.add_argument("--skybox", default=None,
                        help="cubemap dir (px/nx/... faces) or .ktx")
    parser.add_argument("--ai-checkpoint", default=None,
                        help="checkpoint dir: enable frame interpolation blending")
    parser.add_argument("--ai-blend", type=float, default=0.35)
    parser.add_argument("--ai-upscale", action="store_true",
                        help="render at half res + neural 2x reconstruction "
                             "(assets_out/upscaler_2x checkpoint)")
    args = parser.parse_args(argv)

    from trident.app import Application
    from trident.core.config import AiConfig, EngineConfig, RenderConfig
    from trident.ecs.components import (
        LightComponent, LightType, MeshComponent, TextureComponent,
        TransformComponent,
    )
    from trident.geometry.primitives import PrimitiveType
    from trident.io.image import checkerboard, save_png

    cfg = EngineConfig(
        render=RenderConfig(width=args.width, height=args.height,
                            shadows=args.shadows, shadow_pcf=args.pcf, bloom=args.bloom,
                            supersample=args.supersample,
                            sampling=args.sampling,
                            ai_upscale=args.ai_upscale),
        ai=AiConfig(model_path=args.ai_checkpoint,
                    enabled=bool(args.ai_checkpoint), blend=args.ai_blend),
    )
    app = Application(cfg)
    reg = app.scene.editor_registry

    if args.scene:
        app.scene.load(args.scene, asset_importer=lambda p: _importer(app, p))
        reg = app.scene.editor_registry
        app.renderer.set_active_registry(reg)
    if args.model:
        app.import_assets(args.model)
    if not args.model and not args.scene:
        # default showpiece: textured cube + sphere + ground + lights
        slot = app.renderer.acquire_texture("checker", checkerboard(128, 8))
        for pos, scale, prim, tex in (
                ([0, 0, 0], [1, 1, 1], PrimitiveType.CUBE, True),
                ([1.6, 0.35, -0.5], [0.9, 0.9, 0.9], PrimitiveType.SPHERE, False),
                ([0, -0.8, 0], [10, 0.1, 10], PrimitiveType.CUBE, False)):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array(pos, np.float32)
            t.scale = np.array(scale, np.float32)
            reg.add(e, MeshComponent(
                mesh_index=app.renderer.ensure_primitive(prim)))
            if tex:
                reg.add(e, TextureComponent(path="checker", slot=slot))
        sun = reg.create()
        reg.add(sun, TransformComponent())
        reg.add(sun, LightComponent(
            light_type=LightType.DIRECTIONAL,
            direction=np.array([-0.4, -1.0, -0.3], np.float32),
            intensity=4.0, cast_shadows=True))

    if args.skybox:
        from trident.assets.skybox import load_skybox_mips

        levels = load_skybox_mips(args.skybox)
        app.renderer.set_skybox(levels[0], mips=levels[1:])
    else:
        from trident.assets.skybox import solid_skybox

        app.renderer.set_skybox(solid_skybox((0.18, 0.28, 0.45)))

    os.makedirs(args.out, exist_ok=True)
    if args.video:
        app.video_encoder.begin_session(args.video, args.width, args.height)

    cam = app.renderer.editor_camera
    for k in range(args.frames):
        angle = np.radians(args.orbit_degrees * k / max(args.frames, 1))
        cam.set_position([4.5 * np.sin(angle), 2.2, 4.5 * np.cos(angle)])
        cam.look_at_target([0, 0, 0])
        app.update()
        out = app.render()
        app.renderer.queue_text(
            app.renderer.active_viewport,
            f"frame {k}  {app.renderer.stats_triangles} tris", 6, 6,
            (1, 1, 0, 1), 13)
        frame = app.renderer.present()
        save_png(os.path.join(args.out, f"frame_{k:04d}.png"), frame)
        print(f"frame {k}: {frame.shape}", flush=True)

    if args.video:
        print("video:", app.video_encoder.end_session())
    app.shutdown()
    print(f"wrote {args.frames} frames to {args.out}")
    return 0


def _importer(app, path):
    from trident.assets.model_loader import load_model

    data = load_model(path)
    base, _ = app.renderer.append_meshes(data.meshes, data.materials)
    return base, len(data.meshes)


if __name__ == "__main__":
    sys.exit(main())
