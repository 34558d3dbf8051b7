"""Binary FBX import: container parsing, meshes, materials, skins, clips.

No FBX assets can ship with the repo, so the test writes REAL binary FBX
files (v7400 container, zlib-free arrays) with the same node layout
Mixamo/DCC exporters produce, then loads them through the public
load_model path (reference behavior: ModelLoader.cpp:27-38 via Assimp).
"""

import struct
import unittest.mock as mock

import numpy as np
import pytest

from trident.assets.model_loader import load_model


# -- minimal binary FBX writer -------------------------------------------------

def _prop_bytes(p) -> bytes:
    if isinstance(p, bool):
        return b"C" + struct.pack("<B", int(p))
    if isinstance(p, int):
        return b"L" + struct.pack("<q", p)
    if isinstance(p, float):
        return b"D" + struct.pack("<d", p)
    if isinstance(p, str):
        raw = p.encode()
        return b"S" + struct.pack("<I", len(raw)) + raw
    if isinstance(p, (bytes, bytearray)):
        return b"R" + struct.pack("<I", len(p)) + bytes(p)
    arr = np.asarray(p)
    code = {np.dtype(np.float32): b"f", np.dtype(np.float64): b"d",
            np.dtype(np.int64): b"l", np.dtype(np.int32): b"i"}[arr.dtype]
    raw = arr.tobytes()
    return code + struct.pack("<III", arr.size, 0, len(raw)) + raw


def _node_bytes(name: str, props, children, base: int) -> bytes:
    prop_blob = b"".join(_prop_bytes(p) for p in props)
    name_b = name.encode()
    header = 13 + len(name_b)
    body = b""
    pos = base + header + len(prop_blob)
    for cname, cprops, cchildren in children:
        blob = _node_bytes(cname, cprops, cchildren, pos)
        body += blob
        pos += len(blob)
    if children:
        body += b"\x00" * 13                    # null record ends child list
        pos += 13
    end = pos
    return (struct.pack("<III", end, len(props), len(prop_blob))
            + struct.pack("<B", len(name_b)) + name_b + prop_blob + body)


def write_fbx(path: str, top_nodes) -> None:
    buf = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400)
    pos = len(buf)
    for name, props, children in top_nodes:
        blob = _node_bytes(name, props, children, pos)
        buf += blob
        pos += len(blob)
    buf += b"\x00" * 13
    with open(path, "wb") as f:
        f.write(buf)


def _obj_name(name: str, cls: str) -> str:
    return f"{name}\x00\x01{cls}"


def _p(name, ptype, *values):
    return ("P", [name, ptype, "", "A", *values], [])


def _quad_cube():
    """8 vertices, 6 quads — classic FBX cube layout."""
    v = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64)
    quads = [(0, 1, 2, 3), (5, 4, 7, 6), (4, 0, 3, 7),
             (1, 5, 6, 2), (4, 5, 1, 0), (3, 2, 6, 7)]
    pvi = []
    for q in quads:
        pvi.extend([q[0], q[1], q[2], q[3] ^ -1])   # last index XOR -1
    normals = []
    for q in quads:
        p0, p1, p2 = v[q[0]], v[q[1]], v[q[2]]
        n = np.cross(p1 - p0, p2 - p0)
        n = n / np.linalg.norm(n)
        normals.extend([n, n, n, n])
    uv_table = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    uv_index = np.tile([0, 1, 2, 3], len(quads))
    return (v.reshape(-1), np.asarray(pvi, np.int32),
            np.asarray(normals, np.float64).reshape(-1),
            uv_table.reshape(-1), uv_index.astype(np.int32))


def _geometry_node(gid: int):
    verts, pvi, normals, uv, uvi = _quad_cube()
    return ("Geometry", [gid, _obj_name("cubegeo", "Geometry"), "Mesh"], [
        ("Vertices", [verts], []),
        ("PolygonVertexIndex", [pvi], []),
        ("LayerElementNormal", [0], [
            ("MappingInformationType", ["ByPolygonVertex"], []),
            ("ReferenceInformationType", ["Direct"], []),
            ("Normals", [normals], []),
        ]),
        ("LayerElementUV", [0], [
            ("MappingInformationType", ["ByPolygonVertex"], []),
            ("ReferenceInformationType", ["IndexToDirect"], []),
            ("UV", [uv], []),
            ("UVIndex", [uvi], []),
        ]),
        ("LayerElementMaterial", [0], [
            ("MappingInformationType", ["AllSame"], []),
            ("ReferenceInformationType", ["IndexToDirect"], []),
            ("Materials", [np.zeros(1, np.int32)], []),
        ]),
    ])


def _write_static_cube(path):
    nodes = [
        ("Objects", [], [
            _geometry_node(100),
            ("Model", [200, _obj_name("cube", "Model"), "Mesh"], [
                ("Properties70", [], [
                    _p("Lcl Translation", "Lcl Translation", 2.0, 0.0, 0.0),
                    _p("Lcl Scaling", "Lcl Scaling", 1.0, 1.0, 1.0),
                ]),
            ]),
            ("Material", [300, _obj_name("red", "Material"), ""], [
                ("Properties70", [], [
                    _p("DiffuseColor", "Color", 0.8, 0.2, 0.1),
                    _p("Shininess", "double", 32.0),
                ]),
            ]),
        ]),
        ("Connections", [], [
            ("C", ["OO", 200, 0], []),
            ("C", ["OO", 100, 200], []),
            ("C", ["OO", 300, 200], []),
        ]),
    ]
    write_fbx(path, nodes)


def test_fbx_static_mesh(tmp_path):
    path = str(tmp_path / "cube.fbx")
    _write_static_cube(path)
    data = load_model(path)
    assert len(data.meshes) == 1
    mesh = data.meshes[0]
    assert mesh.triangle_count == 12
    assert mesh.positions.shape[0] == 24          # split by normal per face
    assert np.allclose(np.abs(mesh.positions).max(), 1.0)
    # instance transform carries the model's Lcl Translation
    assert np.allclose(data.instance_transforms[0][:3, 3], [2.0, 0.0, 0.0])
    mat = data.materials[mesh.material_index]
    assert np.allclose(mat.base_color[:3], [0.8, 0.2, 0.1])
    assert 0.045 <= mat.roughness < 1.0
    # winding: front faces survive backface culling when rendered — proxy
    # check: every face normal agrees with its geometric normal
    tri = mesh.indices.reshape(-1, 3)
    p = mesh.positions
    geo_n = np.cross(p[tri[:, 1]] - p[tri[:, 0]], p[tri[:, 2]] - p[tri[:, 0]])
    geo_n /= np.linalg.norm(geo_n, axis=1, keepdims=True)
    stored = mesh.normals[tri[:, 0]]
    # source is CCW-front; loader reverses winding, so geometric normals
    # now OPPOSE the stored (authored) normals — the engine convention
    # (same flip the OBJ loader applies, model_loader.py:201-205)
    assert np.allclose((geo_n * stored).sum(axis=1), -1.0, atol=1e-5)


def _write_skinned_two_bone(path, with_anim=True):
    """A 2-bone 'arm': cube skinned half to root, half to child bone."""
    verts, pvi, normals, uv, uvi = _quad_cube()
    lower = [i for i in range(8) if [verts.reshape(8, 3)][0][i][1] < 0]
    upper = [i for i in range(8) if [verts.reshape(8, 3)][0][i][1] >= 0]
    ident = np.eye(4, dtype=np.float64).reshape(-1)

    curves = []
    if with_anim:
        ktime = (np.array([0.0, 0.5, 1.0]) * 46186158000).astype(np.int64)
        for cid, axis_vals in ((603, [0.0, 1.0, 2.0]), (604, [0.0, 0.0, 0.0]),
                               (605, [0.0, 0.0, 0.0])):
            curves.append(("AnimationCurve", [cid, _obj_name("", "AnimCurve"), ""], [
                ("KeyTime", [ktime], []),
                ("KeyValueFloat", [np.asarray(axis_vals, np.float32)], []),
            ]))

    nodes = [
        ("Objects", [], [
            _geometry_node(100),
            ("Model", [200, _obj_name("arm", "Model"), "Mesh"], []),
            ("Model", [400, _obj_name("mixamorig:Hips", "Model"), "LimbNode"], [
                ("Properties70", [], [
                    _p("Lcl Translation", "Lcl Translation", 0.0, -1.0, 0.0)]),
            ]),
            ("Model", [401, _obj_name("mixamorig:Spine", "Model"), "LimbNode"], [
                ("Properties70", [], [
                    _p("Lcl Translation", "Lcl Translation", 0.0, 2.0, 0.0),
                    _p("PreRotation", "Vector3D", 0.0, 0.0, 90.0)]),
            ]),
            ("Deformer", [500, _obj_name("", "Deformer"), "Skin"], []),
            ("Deformer", [501, _obj_name("", "SubDeformer"), "Cluster"], [
                ("Indexes", [np.asarray(lower, np.int32)], []),
                ("Weights", [np.ones(len(lower), np.float64)], []),
                ("Transform", [ident.copy()], []),
                ("TransformLink", [ident.copy()], []),
            ]),
            ("Deformer", [502, _obj_name("", "SubDeformer"), "Cluster"], [
                ("Indexes", [np.asarray(upper, np.int32)], []),
                ("Weights", [np.ones(len(upper), np.float64)], []),
                ("Transform", [ident.copy()], []),
                ("TransformLink", [ident.copy()], []),
            ]),
            ("AnimationStack", [600, _obj_name("wave", "AnimStack"), ""], []),
            ("AnimationLayer", [601, _obj_name("base", "AnimLayer"), ""], []),
            ("AnimationCurveNode", [602, _obj_name("T", "AnimCurveNode"), ""], []),
            *curves,
        ]),
        ("Connections", [], [
            ("C", ["OO", 200, 0], []),
            ("C", ["OO", 100, 200], []),
            ("C", ["OO", 400, 0], []),
            ("C", ["OO", 401, 400], []),
            ("C", ["OO", 500, 100], []),
            ("C", ["OO", 501, 500], []),
            ("C", ["OO", 502, 500], []),
            ("C", ["OO", 400, 501], []),
            ("C", ["OO", 401, 502], []),
            ("C", ["OO", 601, 600], []),
            ("C", ["OO", 602, 601], []),
            ("C", ["OP", 602, 401, "Lcl Translation"], []),
            ("C", ["OP", 603, 602, "d|X"], []),
            ("C", ["OP", 604, 602, "d|Y"], []),
            ("C", ["OP", 605, 602, "d|Z"], []),
        ]),
    ]
    write_fbx(path, nodes)


def test_fbx_skin_and_clip(tmp_path):
    path = str(tmp_path / "arm.fbx")
    _write_skinned_two_bone(path)
    data = load_model(path)
    assert data.skeleton is not None and len(data.skeleton) == 2
    hips = data.skeleton.bones[0]
    spine = data.skeleton.bones[1]
    # Mixamo prefix normalized, source name preserved (AnimationRemap)
    assert hips.name == "Hips" and hips.source_name == "mixamorig:Hips"
    assert spine.parent == 0
    # PreRotation composed into the local bind
    assert np.allclose(spine.local_bind[:3, 3], [0.0, 2.0, 0.0], atol=1e-6)
    assert np.allclose(spine.local_bind[0, 0], 0.0, atol=1e-6)  # 90° about Z

    mesh = data.meshes[0]
    assert (mesh.bone_indices >= 0).any()
    w = mesh.bone_weights.sum(axis=1)
    assert np.allclose(w[mesh.bone_indices[:, 0] >= 0], 1.0, atol=1e-5)

    assert len(data.clips) == 1
    clip = data.clips[0]
    assert clip.name == "wave"
    assert clip.duration == pytest.approx(1.0)
    ch = clip.channels[0]
    assert ch.bone_name == "mixamorig:Spine"
    assert np.allclose(ch.positions[:, 0], [0.0, 1.0, 2.0], atol=1e-6)
    # rotations carry the PreRotation (90° about Z → w=cos45)
    assert np.allclose(np.abs(ch.rotations[0, 0]), np.cos(np.pi / 4), atol=1e-5)


def test_fbx_renders_skinned(tmp_path):
    """End-to-end: the skinned FBX imports as entities, animates through
    the ECS AnimationSystem and renders (same drive as the glTF test,
    tests/test_assets.py::test_skinned_render_end_to_end)."""
    from trident.assets.scene_loader import import_model_entities
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.components import AnimationComponent
    from trident.ecs.scene import Scene
    from trident.render.renderer import Renderer

    path = str(tmp_path / "arm.fbx")
    _write_skinned_two_bone(path)

    r = Renderer(EngineConfig(render=RenderConfig(width=128, height=128,
                                                  use_pallas=False)))
    scene = Scene(renderer=r)
    r.set_active_registry(scene.editor_registry)
    ents = import_model_entities(path, scene.editor_registry, r)
    assert len(ents) == 1
    scene.editor_registry.add(ents[0], AnimationComponent(
        skeleton_asset=path, animation_asset=path, clip_index=0,
        playing=True, looping=False))
    r.editor_camera.set_position([0, 0, 9])
    r.editor_camera.look_at_target([0, 0, 0])

    scene.play()
    r.set_active_registry(scene.runtime_registry)
    scene.update(0.0)
    img0 = r.read_frame()
    scene.update(1.0)          # spine bone translated +2 in x by the clip
    img1 = r.read_frame()
    assert img0.shape == (128, 128, 4)
    assert (np.asarray(r.viewports[0].last_frame.tri_id) >= 0).sum() > 100
    # the animation must visibly move pixels
    assert (img0[..., :3].astype(int) - img1[..., :3].astype(int)).any()


# -- ASCII FBX (same node trees, text container) -------------------------------

def write_fbx_ascii(path: str, top_nodes) -> None:
    """Serialize the same node-tree fixtures as FBX ASCII 7.4 text."""
    lines = ["; FBX 7.4.0 project file",
             "FBXHeaderExtension:  {", "\tFBXVersion: 7400", "}"]

    def fmt(p):
        if isinstance(p, bool):
            return str(int(p))
        if isinstance(p, str):
            if "\x00\x01" in p:
                name, cls = p.split("\x00\x01", 1)
                return f'"{cls}::{name}"'
            return f'"{p}"'
        if isinstance(p, float):
            return repr(p)
        return str(int(p))

    def emit(name, props, children, depth):
        ind = "\t" * depth
        arrays = [p for p in props if isinstance(p, np.ndarray)]
        if arrays:
            a = np.asarray(arrays[0]).reshape(-1)
            if a.dtype.kind == "f":
                body = ",".join(repr(float(v)) for v in a)
            else:
                body = ",".join(str(int(v)) for v in a)
            lines.append(f"{ind}{name}: *{a.size} {{")
            lines.append(f"{ind}\ta: {body}")
            lines.append(f"{ind}}}")
            return
        head = f"{ind}{name}: " + ", ".join(fmt(p) for p in props)
        if children:
            lines.append(head.rstrip() + (" {" if props else "{"))
            for c in children:
                emit(*c, depth + 1)
            lines.append(ind + "}")
        else:
            lines.append(head)

    for name, props, children in top_nodes:
        emit(name, props, children, 0)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write_static_cube_ascii(path):
    import unittest.mock as mock
    with mock.patch(f"{__name__}.write_fbx", write_fbx_ascii):
        _write_static_cube(path)


def test_fbx_ascii_matches_binary_static(tmp_path):
    """The ASCII container parses into the identical document: every mesh,
    material, and transform matches the binary load bit-for-bit."""
    pb, pa = str(tmp_path / "b.fbx"), str(tmp_path / "a.fbx")
    _write_static_cube(pb)
    _write_static_cube_ascii(pa)
    with open(pa, "rb") as f:
        assert not f.read().startswith(b"Kaydara")   # genuinely text
    db, da = load_model(pb), load_model(pa)
    assert len(da.meshes) == len(db.meshes) == 1
    np.testing.assert_array_equal(da.meshes[0].positions, db.meshes[0].positions)
    np.testing.assert_array_equal(da.meshes[0].indices, db.meshes[0].indices)
    np.testing.assert_array_equal(da.meshes[0].normals, db.meshes[0].normals)
    np.testing.assert_array_equal(da.meshes[0].uvs, db.meshes[0].uvs)
    np.testing.assert_allclose(da.instance_transforms[0],
                               db.instance_transforms[0])
    np.testing.assert_allclose(da.materials[0].base_color,
                               db.materials[0].base_color)


def test_fbx_ascii_matches_binary_skinned(tmp_path):
    import unittest.mock as mock

    pb, pa = str(tmp_path / "b.fbx"), str(tmp_path / "a.fbx")
    _write_skinned_two_bone(pb)
    with mock.patch(f"{__name__}.write_fbx", write_fbx_ascii):
        _write_skinned_two_bone(pa)
    db, da = load_model(pb), load_model(pa)
    assert len(da.skeleton) == len(db.skeleton) == 2
    assert [b.name for b in da.skeleton.bones] == \
        [b.name for b in db.skeleton.bones]
    np.testing.assert_allclose(da.skeleton.bones[1].local_bind,
                               db.skeleton.bones[1].local_bind, atol=1e-6)
    np.testing.assert_array_equal(da.meshes[0].bone_indices,
                                  db.meshes[0].bone_indices)
    np.testing.assert_allclose(da.meshes[0].bone_weights,
                               db.meshes[0].bone_weights)
    assert len(da.clips) == 1 and da.clips[0].name == db.clips[0].name
    np.testing.assert_allclose(da.clips[0].channels[0].positions,
                               db.clips[0].channels[0].positions, atol=1e-6)
    np.testing.assert_allclose(da.clips[0].channels[0].rotations,
                               db.clips[0].channels[0].rotations, atol=1e-6)


def test_fbx_garbage_rejected(tmp_path):
    p = str(tmp_path / "junk.fbx")
    with open(p, "wb") as f:
        f.write(b"\x89PNG not an fbx at all")
    with pytest.raises(Exception, match="FBX"):
        load_model(p)


def _capture_nodes(fixture_fn, path):
    """Run a write_fbx-based fixture but capture its node tree instead of
    writing, so tests can splice nodes before serializing themselves."""
    captured = {}
    with mock.patch(f"{__name__}.write_fbx",
                    lambda p, top: captured.update(nodes=top)):
        fixture_fn(path)
    return captured["nodes"]


def test_fbx_instanced_geometry_emits_all_models(tmp_path):
    """One Geometry OO-connected to N Models is FBX instancing: every
    parent Model must yield a mesh entry with its own transform (the
    welded arrays are shared)."""
    path = str(tmp_path / "inst.fbx")
    nodes = [
        ("Objects", [], [
            _geometry_node(100),
            ("Model", [200, _obj_name("treeA", "Model"), "Mesh"], [
                ("Properties70", [], [
                    _p("Lcl Translation", "Lcl Translation", 2.0, 0.0, 0.0)]),
            ]),
            ("Model", [201, _obj_name("treeB", "Model"), "Mesh"], [
                ("Properties70", [], [
                    _p("Lcl Translation", "Lcl Translation", -5.0, 0.0, 0.0)]),
            ]),
        ]),
        ("Connections", [], [
            ("C", ["OO", 200, 0], []),
            ("C", ["OO", 201, 0], []),
            ("C", ["OO", 100, 200], []),
            ("C", ["OO", 100, 201], []),
        ]),
    ]
    write_fbx(path, nodes)
    data = load_model(path)
    assert len(data.meshes) == 2
    xs = sorted(t[0, 3] for t in data.instance_transforms)
    assert xs == pytest.approx([-5.0, 2.0])
    np.testing.assert_array_equal(data.meshes[0].positions,
                                  data.meshes[1].positions)


def test_fbx_clip_duration_ignores_non_bone_tracks(tmp_path):
    """Camera/mesh-node tracks must not inflate clip.duration: the runtime
    samples bone channels only, so a 10s camera track on a 1s skeletal
    clip would freeze loops in the end pose for 9s."""
    path = str(tmp_path / "arm.fbx")
    _write_skinned_two_bone(path)
    base_duration = load_model(path).clips[0].duration

    # rebuild with an extra 10s track targeting the MESH model (id 200)
    nodes = _capture_nodes(_write_skinned_two_bone, path)
    ktime10 = (np.array([0.0, 10.0]) * 46186158000).astype(np.int64)
    nodes[0][2].extend([
        ("AnimationCurveNode", [702, _obj_name("T", "AnimCurveNode"), ""], []),
        ("AnimationCurve", [703, _obj_name("", "AnimCurve"), ""], [
            ("KeyTime", [ktime10], []),
            ("KeyValueFloat", [np.asarray([0.0, 4.0], np.float32)], []),
        ]),
    ])
    nodes[1][2].extend([
        ("C", ["OO", 702, 601], []),
        ("C", ["OP", 702, 200, "Lcl Translation"], []),
        ("C", ["OP", 703, 702, "d|X"], []),
    ])
    path2 = str(tmp_path / "arm2.fbx")
    write_fbx(path2, nodes)
    data2 = load_model(path2)
    assert data2.clips[0].duration == pytest.approx(base_duration)


def test_fbx_pivoted_bone_animation_bakes_full_chain(tmp_path):
    """An animated bone with RotationPivot: the baked T·R·S channel must
    reproduce local_matrix()'s full pivot chain, not the raw Lcl values
    (3ds Max exports pivots routinely)."""
    path = str(tmp_path / "arm.fbx")
    nodes = _capture_nodes(_write_skinned_two_bone, path)
    # give the animated bone (Spine, id 401) a rotation pivot, drop its
    # PreRotation, and switch its animation to a Z rotation 0 -> 90 deg
    for node in nodes[0][2]:
        if node[0] == "Model" and node[1][0] == 401:
            props = node[2][0][2]
            props[:] = [p for p in props if p[1][0] != "PreRotation"]
            props.append(_p("RotationPivot", "Vector3D", 0.0, 1.0, 0.0))
        if node[0] == "AnimationCurve" and node[1][0] == 603:
            node[2][1] = ("KeyValueFloat",
                          [np.asarray([0.0, 45.0, 90.0], np.float32)], [])
    conns = nodes[1][2]
    for i, c in enumerate(conns):
        if c[1][:3] == ["OP", 602, 401]:
            conns[i] = ("C", ["OP", 602, 401, "Lcl Rotation"], [])
    write_fbx(path, nodes)
    data = load_model(path)
    ch = next(c for c in data.clips[0].channels
              if "spine" in c.bone_name.lower())
    # t=0: rotation identity -> pivot cancels -> raw translation (0,2,0)
    np.testing.assert_allclose(ch.positions[0], [0.0, 2.0, 0.0], atol=1e-5)
    # the curve animates d|X -> Rx(90) at t=end; the pivot sits on Y so
    # it does NOT cancel: trans = t + rp + Rx90 @ (-rp)
    #                           = (0,2,0) + (0,1,0) + (0,0,-1) = (0,3,-1)
    np.testing.assert_allclose(ch.positions[-1], [0.0, 3.0, -1.0], atol=1e-4)


def test_fbx_ascii_msvc_inf_literals(tmp_path):
    """Windows printf writes 1.#INF / -1.#IND into ASCII arrays; the
    tokenizer must treat them as one non-finite number (sanitized to 0
    downstream) instead of splitting into '1.' + ident and shifting every
    later element."""
    path = str(tmp_path / "cube.fbx")
    with mock.patch(f"{__name__}.write_fbx", write_fbx_ascii):
        _write_static_cube(path)
    verts, _, _, _, _ = _quad_cube()
    text = open(path).read()
    assert str(float(verts[0])) in text
    text = text.replace(str(float(verts[0])), "1.#INF", 1)
    open(path, "w").write(text)
    data = load_model(path)
    assert len(data.meshes) == 1
    m = data.meshes[0]
    assert np.isfinite(m.positions).all()
    # the remaining coordinates must NOT have shifted: the cube still
    # spans +-1 on y/z
    assert m.positions[:, 1].min() == pytest.approx(-1.0)
    assert m.positions[:, 2].max() == pytest.approx(1.0)


def test_fbx_truncated_uv_index_degrades(tmp_path):
    """A UVIndex array shorter than the corner count must degrade (pad
    with the last value) instead of crashing the per-corner gather."""
    path = str(tmp_path / "cube.fbx")
    nodes = _capture_nodes(_write_static_cube, path)
    geo = nodes[0][2][0]
    for layer in geo[2]:
        if layer[0] == "LayerElementUV":
            for i, sub in enumerate(layer[2]):
                if sub[0] == "UVIndex":
                    layer[2][i] = ("UVIndex", [sub[1][0][:5]], [])
    write_fbx(path, nodes)
    data = load_model(path)
    assert len(data.meshes) == 1
    assert np.isfinite(data.meshes[0].uvs).all()
