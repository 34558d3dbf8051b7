"""Asset pipeline: OBJ/MTL and glTF (incl. skins + animations)."""

import base64
import json
import os
import struct

import numpy as np
import pytest

from trident.assets.model_loader import load_model, load_obj


def write_obj(tmp_path):
    (tmp_path / "box.mtl").write_text(
        "newmtl red\nKd 0.8 0.1 0.1\nNs 32\n\nnewmtl blue\nKd 0.1 0.1 0.9\nPm 0.5\nPr 0.3\n")
    (tmp_path / "box.obj").write_text("""mtllib box.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1
usemtl blue
f -4/-4/-1 -2/-2/-1 -1/-1/-1
""")
    return str(tmp_path / "box.obj")


def test_obj_two_materials(tmp_path):
    data = load_obj(write_obj(tmp_path))
    assert len(data.meshes) == 2
    assert len(data.materials) == 2
    red = data.materials[data.meshes[0].material_index]
    assert red.base_color[0] == pytest.approx(0.8)
    blue = data.materials[data.meshes[1].material_index]
    assert blue.metallic == pytest.approx(0.5)
    assert blue.roughness == pytest.approx(0.3)
    # negative indices resolved: second mesh uses verts 1,3,4
    m2 = data.meshes[1]
    assert m2.vertex_count == 3
    # normals present and unit length
    for m in data.meshes:
        np.testing.assert_allclose(np.linalg.norm(m.normals, axis=1), 1.0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(m.tangents, axis=1), 1.0, atol=1e-4)


def make_skinned_gltf(tmp_path):
    """Two-bone skinned quad strip + a 1s animation rotating bone 1."""
    # vertices: 4 verts, bottom two bound to joint0, top two to joint1
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    normals = np.tile([0, 0, 1], (4, 1)).astype(np.float32)
    joints = np.array([[0, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]], np.uint16)
    weights = np.array([[1, 0, 0, 0]] * 4, np.float32)
    indices = np.array([0, 1, 2, 2, 1, 3], np.uint16)
    inv_binds = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    inv_binds[1, 1, 3] = -1.0  # joint1 sits at y=1
    # column-major flatten
    ibm = inv_binds.transpose(0, 2, 1).reshape(-1)
    times = np.array([0.0, 1.0], np.float32)
    # rotation of joint1: identity → 90° about z (xyzw)
    rots = np.array([[0, 0, 0, 1], [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]], np.float32)

    blob = b"".join(a.tobytes() for a in
                    [positions, normals, joints, weights, indices, ibm.astype(np.float32), times, rots])
    offsets = []
    o = 0
    for a in [positions, normals, joints, weights, indices, ibm.astype(np.float32), times, rots]:
        offsets.append(o)
        o += a.nbytes

    doc = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0, 2]}],
        "nodes": [
            {"name": "root_joint", "children": [1]},
            {"name": "tip_joint", "translation": [0, 1, 0]},
            {"name": "meshnode", "mesh": 0, "skin": 0},
        ],
        "skins": [{"joints": [0, 1], "inverseBindMatrices": 5}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "JOINTS_0": 2, "WEIGHTS_0": 3},
            "indices": 4,
        }]}],
        "animations": [{
            "name": "bend",
            "samplers": [{"input": 6, "output": 7, "interpolation": "LINEAR"}],
            "channels": [{"sampler": 0, "target": {"node": 1, "path": "rotation"}}],
        }],
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode()}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": offsets[0], "byteLength": positions.nbytes},
            {"buffer": 0, "byteOffset": offsets[1], "byteLength": normals.nbytes},
            {"buffer": 0, "byteOffset": offsets[2], "byteLength": joints.nbytes},
            {"buffer": 0, "byteOffset": offsets[3], "byteLength": weights.nbytes},
            {"buffer": 0, "byteOffset": offsets[4], "byteLength": indices.nbytes},
            {"buffer": 0, "byteOffset": offsets[5], "byteLength": ibm.nbytes},
            {"buffer": 0, "byteOffset": offsets[6], "byteLength": times.nbytes},
            {"buffer": 0, "byteOffset": offsets[7], "byteLength": rots.nbytes},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5123, "count": 4, "type": "VEC4"},
            {"bufferView": 3, "componentType": 5126, "count": 4, "type": "VEC4"},
            {"bufferView": 4, "componentType": 5123, "count": 6, "type": "SCALAR"},
            {"bufferView": 5, "componentType": 5126, "count": 2, "type": "MAT4"},
            {"bufferView": 6, "componentType": 5126, "count": 2, "type": "SCALAR"},
            {"bufferView": 7, "componentType": 5126, "count": 2, "type": "VEC4"},
        ],
    }
    path = tmp_path / "rig.gltf"
    path.write_text(json.dumps(doc))
    return str(path)


def test_gltf_skinned(tmp_path):
    data = load_model(make_skinned_gltf(tmp_path))
    assert len(data.meshes) == 1
    mesh = data.meshes[0]
    assert mesh.skinned
    assert data.skeleton is not None and len(data.skeleton) == 2
    assert data.skeleton.bones[1].parent == 0
    np.testing.assert_allclose(data.skeleton.bones[1].inverse_bind[1, 3], -1.0)
    assert len(data.clips) == 1
    clip = data.clips[0]
    assert clip.duration == pytest.approx(1.0)
    # wxyz conversion: last key w == cos(45°)
    ch = clip.channels[0]
    np.testing.assert_allclose(ch.rotations[1, 0], np.cos(np.pi / 4), atol=1e-6)


def test_gltf_animation_drives_skinning(tmp_path):
    from trident.anim.player import AnimationPlayer

    data = load_model(make_skinned_gltf(tmp_path))
    player = AnimationPlayer(data.skeleton)
    player.set_clip(data.clips[0])
    player.playing = True
    player.looping = False
    palette = player.update(1.0)
    # a point at the tip joint's origin (0,1,0): rotated 90° about z around
    # the joint → stays at joint pivot
    p = palette[1] @ np.array([0, 1, 0, 1.0])
    np.testing.assert_allclose(p[:3], [0, 1, 0], atol=1e-5)
    # a point one unit above the tip joint ends up rotated toward -x
    p2 = palette[1] @ np.array([0, 2, 0, 1.0])
    np.testing.assert_allclose(p2[:3], [-1, 1, 0], atol=1e-5)


def test_glb_roundtrip(tmp_path):
    # wrap the .gltf JSON (external-data-free) into a GLB container
    gltf_path = make_skinned_gltf(tmp_path)
    doc = json.loads(open(gltf_path).read())
    payload = json.dumps(doc).encode()
    pad = (4 - len(payload) % 4) % 4
    payload += b" " * pad
    glb = struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(payload))
    glb += struct.pack("<II", len(payload), 0x4E4F534A) + payload
    glb_path = tmp_path / "rig.glb"
    glb_path.write_bytes(glb)
    data = load_model(str(glb_path))
    assert len(data.meshes) == 1 and data.skeleton is not None


def test_skinned_render_end_to_end(tmp_path):
    """Animated glTF → entities → rendered frame with bent quad."""
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.components import AnimationComponent
    from trident.ecs.scene import Scene
    from trident.render.renderer import Renderer
    from trident.assets.scene_loader import import_model_entities

    path = make_skinned_gltf(tmp_path)
    r = Renderer(EngineConfig(render=RenderConfig(width=96, height=96,
                                                  use_pallas=False)))
    scene = Scene(renderer=r)
    r.set_active_registry(scene.editor_registry)
    ents = import_model_entities(path, scene.editor_registry, r)
    assert len(ents) == 1
    reg = scene.editor_registry
    reg.add(ents[0], AnimationComponent(
        skeleton_asset=path, animation_asset=path, clip_index=0,
        playing=True, looping=False))
    r.editor_camera.set_position([0.5, 0.75, 4])
    r.editor_camera.look_at_target([0.5, 0.75, 0])

    scene.play()
    r.set_active_registry(scene.runtime_registry)
    scene.update(0.0)      # bind pose
    img0 = r.read_frame()
    scene.update(1.0)      # fully bent
    img1 = r.read_frame()
    # the animation must visibly change the image
    assert np.abs(img0.astype(int) - img1.astype(int)).max() > 30


def test_gltf_embedded_texture(tmp_path):
    """Data-URI image → textured material without external files."""
    import io
    from PIL import Image

    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :4] = [255, 0, 0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    png_b64 = base64.b64encode(buf.getvalue()).decode()

    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uvs = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    indices = np.array([0, 1, 2], np.uint16)
    blob = positions.tobytes() + uvs.tobytes() + indices.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
            "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}],
        "images": [{"uri": "data:image/png;base64," + png_b64}],
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode()}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": positions.nbytes},
            {"buffer": 0, "byteOffset": positions.nbytes, "byteLength": uvs.nbytes},
            {"buffer": 0, "byteOffset": positions.nbytes + uvs.nbytes,
             "byteLength": indices.nbytes},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 3, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 3, "type": "SCALAR"},
        ],
    }
    p = tmp_path / "embedded.gltf"
    p.write_text(json.dumps(doc))
    data = load_model(str(p))
    assert len(data.textures) == 1
    assert data.textures[0].rgba is not None
    assert data.textures[0].rgba.shape == (8, 8, 4)
    assert data.materials[0].base_color_texture == 0

    # end-to-end: import resolves a texture slot
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.registry import Registry
    from trident.render.renderer import Renderer
    from trident.assets.scene_loader import import_model_entities

    r = Renderer(EngineConfig(render=RenderConfig(width=32, height=32,
                                                  use_pallas=False)))
    reg = Registry()
    r.set_active_registry(reg)
    import_model_entities(str(p), reg, r)
    assert r.geometry.materials[-1].texture_slot == 1


def test_model_hot_reload(tmp_path):
    """Editing a watched model file re-imports it and patches the live
    geometry slots in place (reference: Renderer.cpp:5739-5820): the next
    frame renders the new mesh through the SAME MeshComponent indices. A
    broken edit keeps the old geometry."""
    import os

    from trident.app import Application
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.components import MeshComponent

    assets = tmp_path / "Assets"
    for sub in ("Shaders", "Models", "Textures"):
        (assets / sub).mkdir(parents=True)
    obj = assets / "Models" / "tri.obj"

    def write_obj(scale):
        obj.write_text(
            "v 0 0 0\n"
            f"v {scale} 0 0\n"
            f"v 0 {scale} 0\n"
            "vn 0 0 1\n"
            "f 1//1 2//1 3//1\n")
        os.utime(obj, (os.stat(obj).st_atime, os.stat(obj).st_mtime + 5))

    write_obj(1.0)
    app = Application(EngineConfig(
        assets_root=str(assets),
        render=RenderConfig(width=48, height=48, use_pallas=False)))
    try:
        ents = app.import_assets([str(obj)])
        assert len(ents) == 1
        mesh_idx = app.scene.editor_registry.get(
            ents[0], MeshComponent).mesh_index
        geometry = app.renderer.geometry
        v0 = geometry.meshes[mesh_idx].positions.copy()
        ver0 = geometry.version

        app.file_watcher.poll(now=1e9)     # prime the watcher baseline
        write_obj(2.0)                     # grow the triangle on disk
        app.file_watcher.poll(now=2e9)
        app.process_reload_events()
        v1 = geometry.meshes[mesh_idx].positions
        assert geometry.version > ver0
        assert not np.array_equal(v0, v1)
        assert float(np.abs(v1).max()) == 2.0

        # broken edit (no faces → zero meshes): old geometry must survive
        ver1 = geometry.version
        obj.write_text("v 0 0 0\n")
        os.utime(obj, (os.stat(obj).st_atime, os.stat(obj).st_mtime + 10))
        app.file_watcher.poll(now=3e9)
        app.process_reload_events()
        assert geometry.version == ver1
        np.testing.assert_array_equal(
            np.asarray(geometry.meshes[mesh_idx].positions), np.asarray(v1))
    finally:
        app.shutdown()
