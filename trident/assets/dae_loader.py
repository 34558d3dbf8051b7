"""COLLADA (.dae) loader: meshes, materials, skins, animation clips.

The reference imports DAE through Assimp (reference:
Trident/src/Loader/ModelLoader.cpp:27-38); this is a from-scratch reader
of the COLLADA 1.4/1.5 XML schema subset that DCC exporters emit:

  * library_geometries: <triangles>/<polylist>/<polygons> with per-input
    offsets (VERTEX/NORMAL/TEXCOORD), fan triangulation
  * library_materials/effects: lambert/phong/blinn diffuse color or
    texture (via newparam surface → library_images)
  * library_controllers: <skin> with bind_shape_matrix, JOINT/
    INV_BIND_MATRIX sources, <vertex_weights> (≤4 influences kept,
    renormalized — ModelLoader's aiProcess_LimitBoneWeights behavior)
  * library_visual_scenes: node trees with matrix/translate/rotate/scale,
    instance_geometry/instance_controller; <up_axis>Z_UP</up_axis>
    converts to the engine's Y-up at the instance transform
  * library_animations: channels targeting node transforms — full-matrix
    outputs decompose to TRS; translate/rotate/scale channels sample
    directly. Times are seconds already.

Output contract matches assets/model_loader.ModelData.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from trident.anim.data import (
    AnimationClip,
    Bone,
    Skeleton,
    TransformChannel,
    normalize_bone_name,
)
from trident.core.log import get_logger
from trident.geometry.mesh import Material, Mesh

logger = get_logger("assets.dae")

_Z_UP_TO_Y_UP = np.array([[1, 0, 0, 0],
                          [0, 0, 1, 0],
                          [0, -1, 0, 0],
                          [0, 0, 0, 1]], np.float32)


def _strip(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _floats(text: Optional[str]) -> np.ndarray:
    return (np.asarray((text or "").split(), np.float64)
            if text and text.split() else np.zeros(0, np.float64))


def _ints(text: Optional[str]) -> np.ndarray:
    return (np.asarray((text or "").split(), np.int64)
            if text and text.split() else np.zeros(0, np.int64))


class _Doc:
    """id-indexed view of the XML tree (namespace-agnostic)."""

    def __init__(self, root: ET.Element):
        self.root = root
        self.by_id: Dict[str, ET.Element] = {}
        for el in root.iter():
            eid = el.get("id")
            if eid:
                self.by_id[eid] = el

    def ref(self, url: Optional[str]) -> Optional[ET.Element]:
        if not url:
            return None
        return self.by_id.get(url.lstrip("#"))

    def findall(self, el: ET.Element, name: str) -> List[ET.Element]:
        return [c for c in el.iter() if _strip(c.tag) == name]

    def children(self, el: ET.Element, name: str) -> List[ET.Element]:
        return [c for c in list(el) if _strip(c.tag) == name]

    def child(self, el: ET.Element, name: str) -> Optional[ET.Element]:
        cs = self.children(el, name)
        return cs[0] if cs else None


def _source_floats(doc: _Doc, source: ET.Element) -> Tuple[np.ndarray, int]:
    """<source> → (values (N, stride), stride)."""
    arr_el = doc.child(source, "float_array")
    vals = _floats(arr_el.text if arr_el is not None else "")
    acc = None
    for t in doc.findall(source, "accessor"):
        acc = t
        break
    stride = int(acc.get("stride", "1")) if acc is not None else 1
    if stride <= 0:
        stride = 1
    n = vals.shape[0] // stride
    return vals[: n * stride].reshape(n, stride), stride


def _source_names(doc: _Doc, source: ET.Element) -> List[str]:
    el = doc.child(source, "Name_array")
    if el is None:                      # NB: ET elements are falsy when
        el = doc.child(source, "IDREF_array")  # childless — compare to None
    return (el.text or "").split() if el is not None else []


def _input_map(doc: _Doc, el: ET.Element) -> Dict[str, Tuple[ET.Element, int]]:
    """semantic → (resolved <source>, offset). VERTEX chases <vertices>."""
    out: Dict[str, Tuple[ET.Element, int]] = {}
    for inp in doc.children(el, "input"):
        sem = inp.get("semantic", "")
        off = int(inp.get("offset", "0"))
        src = doc.ref(inp.get("source"))
        if src is None:
            continue
        if sem == "VERTEX":
            for vin in doc.children(src, "input"):
                if vin.get("semantic") == "POSITION":
                    src = doc.ref(vin.get("source"))
            out["POSITION"] = (src, off)
        elif sem in out and int(inp.get("set", "0")) != 0:
            # multi-set inputs (e.g. a set="1" lightmap TEXCOORD): keep the
            # PRIMARY set 0 rather than letting the last input win
            continue
        else:
            out[sem] = (src, off)
    return out


def _node_local(doc: _Doc, node: ET.Element) -> np.ndarray:
    m = np.eye(4)
    for el in list(node):
        tag = _strip(el.tag)
        if tag == "matrix":
            m = m @ _floats(el.text).reshape(4, 4)
        elif tag == "translate":
            t = np.eye(4)
            t[:3, 3] = _floats(el.text)[:3]
            m = m @ t
        elif tag == "rotate":
            vals = _floats(el.text)
            axis, ang = vals[:3], np.radians(vals[3])
            axis = axis / max(np.linalg.norm(axis), 1e-12)
            c, s = np.cos(ang), np.sin(ang)
            x, y, z = axis
            r = np.array([
                [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)]])
            r4 = np.eye(4)
            r4[:3, :3] = r
            m = m @ r4
        elif tag == "scale":
            sm = np.eye(4)
            sm[:3, :3] = np.diag(_floats(el.text)[:3])
            m = m @ sm
    return m


def load_dae(path: str):
    from trident.assets.model_loader import (
        ModelData, TextureRef, _compute_normals, _compute_tangents,
    )

    tree = ET.parse(path)
    root = tree.getroot()
    doc = _Doc(root)
    data = ModelData()
    base_dir = os.path.dirname(os.path.abspath(path))

    up = "Y_UP"
    for el in doc.findall(root, "up_axis"):
        up = (el.text or "Y_UP").strip()
    axis_fix = _Z_UP_TO_Y_UP if up == "Z_UP" else np.eye(4, dtype=np.float32)

    # -- materials --------------------------------------------------------------
    mat_index: Dict[str, int] = {}      # material id → index

    def _effect_color_texture(effect: ET.Element):
        color = (1.0, 1.0, 1.0, 1.0)
        tex_file = None
        # sampler → surface → image indirection
        samplers: Dict[str, str] = {}
        surfaces: Dict[str, str] = {}
        for np_el in doc.findall(effect, "newparam"):
            sid = np_el.get("sid", "")
            surf = doc.child(np_el, "surface")
            if surf is not None:
                init = doc.child(surf, "init_from")
                if init is not None and init.text:
                    surfaces[sid] = init.text.strip()
            s2d = doc.child(np_el, "sampler2D")
            if s2d is not None:
                src = doc.child(s2d, "source")
                if src is not None and src.text:
                    samplers[sid] = src.text.strip()
        for dif in doc.findall(effect, "diffuse"):
            c = doc.child(dif, "color")
            if c is not None:
                vals = _floats(c.text)
                if vals.shape[0] >= 3:
                    color = (float(vals[0]), float(vals[1]), float(vals[2]),
                             float(vals[3]) if vals.shape[0] > 3 else 1.0)
            t = doc.child(dif, "texture")
            if t is not None:
                ref = t.get("texture", "")
                img_id = surfaces.get(samplers.get(ref, ref), ref)
                img = doc.by_id.get(img_id)
                if img is not None:
                    init = doc.child(img, "init_from")
                    if init is not None and init.text:
                        tex_file = init.text.strip().replace("file://", "")
        return color, tex_file

    def _material_for(mat_id: str) -> int:
        mat_id = mat_id.lstrip("#")
        if mat_id in mat_index:
            return mat_index[mat_id]
        mat = Material(name=mat_id or "default")
        mat_el = doc.by_id.get(mat_id)
        if mat_el is not None:
            inst = doc.child(mat_el, "instance_effect")
            effect = doc.ref(inst.get("url")) if inst is not None else None
            if effect is not None:
                color, tex_file = _effect_color_texture(effect)
                mat.base_color = color
                if tex_file:
                    resolved = os.path.normpath(os.path.join(base_dir, tex_file))
                    mat.base_color_texture = len(data.textures)
                    data.textures.append(TextureRef(
                        path=resolved, name=os.path.basename(tex_file)))
        mat_index[mat_id] = len(data.materials)
        data.materials.append(mat)
        return mat_index[mat_id]

    # -- geometry ---------------------------------------------------------------
    def _load_mesh(geom: ET.Element, material_of_symbol: Dict[str, str],
                   skin: Optional[dict], inst: np.ndarray):
        mesh_el = doc.child(geom, "mesh")
        if mesh_el is None:
            return
        for prim in list(mesh_el):
            tag = _strip(prim.tag)
            if tag not in ("triangles", "polylist", "polygons"):
                continue
            inputs = _input_map(doc, prim)
            if "POSITION" not in inputs:
                continue
            pos_src, _ = inputs["POSITION"]
            positions, _ = _source_floats(doc, pos_src)
            n_inputs = 1 + max(off for _s, off in inputs.values())
            if tag == "polygons":
                plists = [_ints(p.text) for p in doc.children(prim, "p")]
            else:
                p_el = doc.child(prim, "p")
                plists = [_ints(p_el.text)] if p_el is not None else []
            if not plists:
                continue
            if tag == "polylist":
                vcounts = _ints(doc.child(prim, "vcount").text)
                flat = plists[0].reshape(-1, n_inputs)
                polys, cursor = [], 0
                for vc in vcounts:
                    polys.append(flat[cursor:cursor + vc])
                    cursor += vc
            elif tag == "polygons":
                polys = [p.reshape(-1, n_inputs) for p in plists]
            else:  # triangles
                polys = list(plists[0].reshape(-1, 3, n_inputs))

            corners = []
            for poly in polys:
                for k in range(1, len(poly) - 1):
                    # COLLADA is CCW-front like OBJ → reverse for the engine
                    corners.extend([poly[0], poly[k + 1], poly[k]])
            tuples = np.asarray(corners, np.int64)       # (3K, n_inputs)

            def fetch(sem, width):
                if sem not in inputs:
                    return None
                src, off = inputs[sem]
                vals, stride = _source_floats(doc, src)
                idx = np.clip(tuples[:, off], 0, vals.shape[0] - 1)
                return vals[idx][:, :width]

            uv_c = fetch("TEXCOORD", 2)
            nrm_c = fetch("NORMAL", 3)
            keys = [tuples[:, inputs["POSITION"][1]][:, None]]
            if uv_c is not None:
                keys.append(np.round(uv_c * 1e6).astype(np.int64))
            if nrm_c is not None:
                keys.append(np.round(nrm_c * 1e4).astype(np.int64))
            kmat = np.concatenate(keys, axis=1)
            _u, first, inverse = np.unique(kmat, axis=0, return_index=True,
                                           return_inverse=True)
            v_src = tuples[:, inputs["POSITION"][1]][first]
            v_pos = positions[np.clip(v_src, 0, positions.shape[0] - 1), :3]
            if skin is not None:
                bsm = skin["bind_shape"]
                v_pos = (np.concatenate(
                    [v_pos, np.ones((v_pos.shape[0], 1))], axis=1)
                    @ bsm.T)[:, :3]
            v_pos = v_pos.astype(np.float32)
            indices = inverse.astype(np.int32)
            v_uv = np.zeros((v_pos.shape[0], 2), np.float32)
            if uv_c is not None:
                v_uv = uv_c[first].astype(np.float32)
                v_uv[:, 1] = 1.0 - v_uv[:, 1]            # flip V
            if nrm_c is not None:
                v_nrm = nrm_c[first].astype(np.float32)
                n = np.linalg.norm(v_nrm, axis=1, keepdims=True)
                v_nrm = (v_nrm / np.maximum(n, 1e-12)).astype(np.float32)
            else:
                v_nrm = _compute_normals(v_pos, indices)
            tan, bit = _compute_tangents(v_pos, v_nrm, v_uv, indices)

            bone_idx = bone_wgt = None
            if skin is not None:
                bone_idx = skin["indices"][v_src]
                bone_wgt = skin["weights"][v_src]

            sym = prim.get("material", "")
            mindex = _material_for(material_of_symbol.get(sym, sym)) \
                if (sym and (sym in material_of_symbol or sym in doc.by_id)) \
                else 0
            if not data.materials:
                data.materials.append(Material(name="default"))
            data.meshes.append(Mesh(
                v_pos, indices, normals=v_nrm, tangents=tan, bitangents=bit,
                uvs=v_uv, bone_indices=bone_idx, bone_weights=bone_wgt,
                material_index=mindex,
                name=geom.get("name") or geom.get("id", "mesh")))
            data.instance_transforms.append(
                (axis_fix @ inst).astype(np.float32))

    # -- skins ------------------------------------------------------------------
    skeleton = Skeleton(name=os.path.basename(path))
    joint_index: Dict[str, int] = {}

    def _load_skin(ctrl: ET.Element) -> Optional[dict]:
        skin_el = doc.child(ctrl, "skin")
        if skin_el is None:
            return None
        geom = doc.ref(skin_el.get("source"))
        if geom is None:
            return None
        bsm_el = doc.child(skin_el, "bind_shape_matrix")
        bind_shape = (_floats(bsm_el.text).reshape(4, 4)
                      if bsm_el is not None else np.eye(4))
        joints_el = doc.child(skin_el, "joints")
        names: List[str] = []
        inv_binds = None
        if joints_el is not None:
            for inp in doc.children(joints_el, "input"):
                src = doc.ref(inp.get("source"))
                if src is None:
                    continue
                if inp.get("semantic") == "JOINT":
                    names = _source_names(doc, src)
                elif inp.get("semantic") == "INV_BIND_MATRIX":
                    vals, _ = _source_floats(doc, src)
                    inv_binds = vals.reshape(-1, 4, 4)
        vw = doc.child(skin_el, "vertex_weights")
        if vw is None:
            return None
        weight_vals = None
        joint_off = weight_off = 0
        for inp in doc.children(vw, "input"):
            src = doc.ref(inp.get("source"))
            if inp.get("semantic") == "JOINT":
                joint_off = int(inp.get("offset", "0"))
            elif inp.get("semantic") == "WEIGHT":
                weight_off = int(inp.get("offset", "1"))
                if src is not None:
                    weight_vals, _ = _source_floats(doc, src)
        vcount = _ints(doc.child(vw, "vcount").text)
        v_el = doc.child(vw, "v")
        v_list = _ints(v_el.text if v_el is not None else "")

        # joints → skeleton bones (hierarchy resolved later from the scene)
        local_idx: List[int] = []
        for k, nm in enumerate(names):
            if nm not in joint_index:
                b = Bone(name=normalize_bone_name(nm), source_name=nm)
                if inv_binds is not None and k < inv_binds.shape[0]:
                    # bind_shape is baked into the vertices, so the file's
                    # INV_BIND_MATRIX is the palette-ready inverse bind
                    b.inverse_bind = inv_binds[k].astype(np.float32)
                joint_index[nm] = skeleton.add_bone(b)
            elif inv_binds is not None and k < inv_binds.shape[0]:
                skeleton.bones[joint_index[nm]].inverse_bind = \
                    inv_binds[k].astype(np.float32)
            local_idx.append(joint_index[nm])

        n_verts = vcount.shape[0]
        bone_idx = np.full((n_verts, 4), -1, np.int32)
        bone_wgt = np.zeros((n_verts, 4), np.float32)
        cursor = 0
        stride = 1 + max(joint_off, weight_off)
        for vi, vc in enumerate(vcount):
            pairs = v_list[cursor:cursor + vc * stride].reshape(vc, stride)
            cursor += vc * stride
            ws = []
            for j in range(vc):
                ji = int(pairs[j, joint_off])
                w = (float(weight_vals[int(pairs[j, weight_off]), 0])
                     if weight_vals is not None else 1.0)
                if ji >= 0 and w > 0:
                    ws.append((w, local_idx[ji] if ji < len(local_idx) else -1))
            ws.sort(reverse=True)
            total = sum(w for w, b in ws[:4] if b >= 0)
            for slot, (w, b) in enumerate(ws[:4]):
                if b < 0:
                    continue
                bone_idx[vi, slot] = b
                bone_wgt[vi, slot] = w / max(total, 1e-8)
        return {"geometry": geom, "bind_shape": bind_shape,
                "indices": bone_idx, "weights": bone_wgt}

    # -- scene traversal ----------------------------------------------------------
    def _walk(node: ET.Element, parent_m: np.ndarray, parent_bone: int):
        local = _node_local(doc, node)
        world = parent_m @ local
        bone_here = parent_bone
        nid = node.get("sid") or node.get("id") or node.get("name") or ""
        if node.get("type") == "JOINT" or nid in joint_index:
            if nid in joint_index:
                b = joint_index[nid]
                skeleton.bones[b].local_bind = local.astype(np.float32)
                if skeleton.bones[b].parent < 0 and parent_bone >= 0 \
                        and b != parent_bone:
                    skeleton.bones[b].parent = parent_bone
                    skeleton.bones[parent_bone].children.append(b)
                bone_here = b
        for el in list(node):
            tag = _strip(el.tag)
            if tag == "instance_geometry":
                geom = doc.ref(el.get("url"))
                if geom is not None:
                    _load_mesh(geom, _bind_materials(el), None, world)
            elif tag == "instance_controller":
                ctrl = doc.ref(el.get("url"))
                skin = skins_by_ctrl.get(id(ctrl)) if ctrl is not None else None
                if skin is not None:
                    _load_mesh(skin["geometry"], _bind_materials(el),
                               skin, world)
            elif tag == "node":
                _walk(el, world, bone_here)

    def _bind_materials(inst_el: ET.Element) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for im in doc.findall(inst_el, "instance_material"):
            out[im.get("symbol", "")] = im.get("target", "").lstrip("#")
        return out

    # register all skins FIRST so the scene walk can resolve joint nodes to
    # bones regardless of document order
    skins_by_ctrl: Dict[int, dict] = {}
    for ctrl in doc.findall(root, "controller"):
        skin = _load_skin(ctrl)
        if skin is not None:
            skins_by_ctrl[id(ctrl)] = skin

    for vs in doc.findall(root, "visual_scene"):
        for node in doc.children(vs, "node"):
            _walk(node, np.eye(4), -1)

    # node ids double as animation targets; keep a node lookup
    # -- animations ---------------------------------------------------------------
    def _component_expand(values: np.ndarray, target: str,
                          node_el, tag: str, default) -> np.ndarray:
        """OUTPUT → (N,3). Component targets (node/translate.X, stride-1
        sources) seed the other components from the node's own <tag>
        element (or `default`) instead of numpy-broadcasting one scalar
        into all three."""
        if values.shape[1] >= 3:
            return values[:, :3].astype(np.float32)
        base = np.asarray(default, np.float32)
        if node_el is not None:
            for el in list(node_el):
                if _strip(el.tag) == tag:
                    base = _floats(el.text)[:3].astype(np.float32)
                    break
        out = np.tile(base, (values.shape[0], 1))
        comp = {"X": 0, "Y": 1, "Z": 2}.get(target.rsplit(".", 1)[-1].upper())
        out[:, comp if comp is not None else 0] = values[:, 0]
        return out

    def _axis_angle_mats(axis: np.ndarray, ang_deg: np.ndarray) -> np.ndarray:
        ax = axis / max(np.linalg.norm(axis), 1e-12)
        a = np.radians(ang_deg)
        c, s = np.cos(a), np.sin(a)
        x, y, z = ax
        k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], np.float64)
        kk = k @ k
        return (np.eye(3)[None] + s[:, None, None] * k[None]
                + (1 - c)[:, None, None] * kk[None])

    def _rotate_axis_for(node_el, target: str) -> np.ndarray:
        """Axis of the <rotate> element a channel like node/rotationZ.ANGLE
        addresses: resolve the sid inside the node, else infer from the
        trailing X/Y/Z letter."""
        sid = target.split("/", 1)[-1].split(".", 1)[0]
        if node_el is not None:
            for el in list(node_el):
                if _strip(el.tag) == "rotate" and el.get("sid") == sid:
                    return _floats(el.text)[:3]
        letter = sid[-1:].upper()
        return {"X": np.array([1.0, 0, 0]), "Y": np.array([0, 1.0, 0]),
                "Z": np.array([0, 0, 1.0])}.get(letter,
                                                np.array([0, 0, 1.0]))

    # bone → [(doc_order, times, axis, angles_deg)] pending single-axis
    # rotation parts, composed after the channel scan (exporters emit one
    # channel per <rotate> element; they apply in node document order)
    rot_parts: Dict[str, list] = {}

    def _rotate_order(node_el, target: str) -> int:
        sid = target.split("/", 1)[-1].split(".", 1)[0]
        if node_el is not None:
            for i, el in enumerate(list(node_el)):
                if _strip(el.tag) == "rotate" and el.get("sid") == sid:
                    return i
        return 0

    clip = AnimationClip(name=os.path.splitext(os.path.basename(path))[0],
                         duration=0.0)
    for anim in doc.findall(root, "animation"):
        for ch in doc.children(anim, "channel"):
            target = ch.get("target", "")
            node_id = target.split("/")[0]
            node_el = doc.by_id.get(node_id)
            bone_name = (node_el.get("sid") or node_el.get("id")
                         or node_id) if node_el is not None else node_id
            sampler = doc.ref(ch.get("source"))
            if sampler is None:
                continue
            times = values = None
            for inp in doc.children(sampler, "input"):
                src = doc.ref(inp.get("source"))
                if src is None:
                    continue
                if inp.get("semantic") == "INPUT":
                    times, _ = _source_floats(doc, src)
                elif inp.get("semantic") == "OUTPUT":
                    values, stride = _source_floats(doc, src)
            if times is None or values is None or times.shape[0] == 0:
                continue
            t = times[:, 0].astype(np.float32)
            tc = TransformChannel(bone_name=bone_name)
            if values.shape[1] == 16:       # baked matrices → decompose TRS
                mats = values.reshape(-1, 4, 4)
                pos = mats[:, :3, 3]
                scale = np.linalg.norm(mats[:, :3, :3], axis=1)
                rot = mats[:, :3, :3] / np.maximum(scale[:, None, :], 1e-12)
                from trident.assets.fbx_loader import _mat3_to_quat_wxyz
                quats = np.stack([_mat3_to_quat_wxyz(r) for r in rot])
                for k in range(1, quats.shape[0]):
                    if np.dot(quats[k], quats[k - 1]) < 0:
                        quats[k] = -quats[k]
                tc.position_times, tc.positions = t, pos.astype(np.float32)
                tc.rotation_times = t
                tc.rotations = quats.astype(np.float32)
                tc.scale_times, tc.scales = t, scale.astype(np.float32)
            elif "translate" in target:
                tc.position_times = t
                tc.positions = _component_expand(values, target, node_el,
                                                 "translate", (0.0, 0.0, 0.0))
            elif "scale" in target:
                tc.scale_times = t
                tc.scales = _component_expand(values, target, node_el,
                                              "scale", (1.0, 1.0, 1.0))
            elif "rotat" in target.lower() and values.shape[1] >= 4:
                # full axis-angle track: quats directly
                from trident.assets.fbx_loader import _mat3_to_quat_wxyz
                # per-key axes may differ; build each key's matrix
                mats = np.stack([
                    _axis_angle_mats(values[k, :3], values[k:k + 1, 3])[0]
                    for k in range(values.shape[0])])
                quats = np.stack([_mat3_to_quat_wxyz(m) for m in mats])
                for k in range(1, quats.shape[0]):
                    if np.dot(quats[k], quats[k - 1]) < 0:
                        quats[k] = -quats[k]
                tc.rotation_times = t
                tc.rotations = quats.astype(np.float32)
            elif "rotat" in target.lower():
                # single-axis .ANGLE channel (SketchUp/3ds Max style):
                # queue for post-scan composition in node document order
                rot_parts.setdefault(bone_name, []).append(
                    (_rotate_order(node_el, target), t,
                     _rotate_axis_for(node_el, target),
                     values[:, 0].astype(np.float64)))
                clip.duration = max(clip.duration, float(t[-1]))
                continue
            else:
                continue
            # merge into an existing channel for the same bone
            existing = next((c for c in clip.channels
                             if c.bone_name == tc.bone_name), None)
            if existing is None:
                clip.channels.append(tc)
            else:
                for fld in ("position_times", "positions", "rotation_times",
                            "rotations", "scale_times", "scales"):
                    if getattr(tc, fld).shape[0]:
                        setattr(existing, fld, getattr(tc, fld))
            clip.duration = max(clip.duration, float(t[-1]))

    # compose queued single-axis rotation parts: resample every part's
    # angle onto the union of key times, multiply the axis matrices in
    # node document order, convert once to continuous quaternions
    for bone, parts in rot_parts.items():
        from trident.assets.fbx_loader import _mat3_to_quat_wxyz

        parts.sort(key=lambda p: p[0])
        union = np.unique(np.concatenate([p[1] for p in parts]))
        total = np.tile(np.eye(3), (len(union), 1, 1))
        for _order, times_p, axis, angles in parts:
            ang_u = np.interp(union, times_p, angles)
            total = total @ _axis_angle_mats(axis, ang_u)
        quats = np.stack([_mat3_to_quat_wxyz(m) for m in total])
        for k in range(1, quats.shape[0]):
            if np.dot(quats[k], quats[k - 1]) < 0:
                quats[k] = -quats[k]
        existing = next((c for c in clip.channels if c.bone_name == bone),
                        None)
        tc = existing or TransformChannel(bone_name=bone)
        tc.rotation_times = union.astype(np.float32)
        tc.rotations = quats.astype(np.float32)
        if existing is None:
            clip.channels.append(tc)
    if clip.channels:
        data.clips.append(clip)

    if not data.materials:
        data.materials.append(Material(name="default"))
    if len(skeleton):
        data.skeleton = skeleton

    logger.info("loaded DAE %s: %d meshes, %d materials, %d bones, %d clips, "
                "%d tris", path, len(data.meshes), len(data.materials),
                len(skeleton), len(data.clips),
                sum(m.triangle_count for m in data.meshes))
    return data
