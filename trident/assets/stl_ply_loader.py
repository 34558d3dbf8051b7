"""STL and PLY mesh loaders → ModelData.

The reference gets both formats for free through Assimp
(Loader/ModelLoader.cpp:27-38 accepts any extension Assimp registers);
these are from-scratch parsers with the same output contract as the other
loaders (assets/model_loader.py): shared-Vertex meshes, default PBR
material, triangle order Morton-sorted by the Mesh constructor.

STL: binary (80-byte header + u32 count + 50-byte records) and ASCII
  ("solid"/"facet normal"/"vertex"). Faceted by nature — per-face normals,
  vertices deduplicated per facet so flat shading is preserved exactly.
PLY: ascii and binary_little_endian 1.0; vertex properties x/y/z,
  nx/ny/nz, u/v (or s/t), red/green/blue[/alpha] (uchar or float), face
  lists fan-triangulated. Missing normals are area-weighted smooth
  normals over shared vertices.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from trident.core.log import get_logger
from trident.geometry.mesh import Material, Mesh

logger = get_logger("assets")


def _model(mesh: Mesh, name: str):
    from trident.assets.model_loader import ModelData

    return ModelData(meshes=[mesh], materials=[Material(name=name)],
                     instance_transforms=[np.eye(4, dtype=np.float32)])


# -- STL -------------------------------------------------------------------------

def load_stl(path: str):
    with open(path, "rb") as f:
        data = f.read()
    name = os.path.splitext(os.path.basename(path))[0]
    tris = _parse_stl_binary(data)
    if tris is None:
        tris = _parse_stl_ascii(data)
    if tris is None or len(tris[0]) == 0:
        raise ValueError(f"{path}: no triangles parsed")
    verts, normals = tris
    n = verts.shape[0]
    # zero/degenerate facet normals → recompute from winding
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    face_n = np.cross(e1, e2)
    ln = np.linalg.norm(face_n, axis=1, keepdims=True)
    face_n = face_n / np.maximum(ln, 1e-12)
    given_ok = np.linalg.norm(normals, axis=1, keepdims=True) > 1e-6
    normals = np.where(given_ok, normals, face_n)
    mesh = Mesh(positions=verts.reshape(n * 3, 3),
                indices=np.arange(n * 3, dtype=np.int32),
                normals=np.repeat(normals, 3, axis=0),
                name=name)
    return _model(mesh, name)


def _parse_stl_binary(data: bytes):
    """Returns ((T,3,3) verts, (T,3) normals) or None if not binary STL.
    Binary files may legally start with b"solid" — trust the exact size
    arithmetic, not the prefix."""
    if len(data) < 84:
        return None
    (count,) = struct.unpack_from("<I", data, 80)
    # several common exporters append trailing bytes after the records, so
    # accept len >= the exact size and parse exactly `count` records (the
    # Assimp-backed reference loads such files; advisor round-4 finding).
    # An ASCII file essentially never satisfies this: its bytes at offset
    # 80 decode to a huge count.
    if len(data) < 84 + 50 * count or count == 0:
        return None
    rec = np.frombuffer(data, np.uint8, 50 * count, 84).reshape(count, 50)
    f = rec[:, :48].copy().view("<f4").reshape(count, 12)
    return (f[:, 3:12].reshape(count, 3, 3).astype(np.float32),
            f[:, 0:3].astype(np.float32))


def _parse_stl_ascii(data: bytes):
    try:
        text = data.decode("utf-8", errors="replace")
    except Exception:
        return None
    verts: List[List[float]] = []
    normals: List[List[float]] = []
    cur_n = [0.0, 0.0, 0.0]
    cur_v: List[List[float]] = []
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        key = parts[0].lower()
        if key == "facet" and len(parts) >= 5 and parts[1] == "normal":
            cur_n = [float(x) for x in parts[2:5]]
            cur_v = []
        elif key == "vertex" and len(parts) >= 4:
            cur_v.append([float(x) for x in parts[1:4]])
        elif key == "endfacet":
            for k in range(1, len(cur_v) - 1):   # fan, tolerate >3 verts
                verts.append([cur_v[0], cur_v[k], cur_v[k + 1]])
                normals.append(cur_n)
    if not verts:
        return None
    return (np.asarray(verts, np.float32),
            np.asarray(normals, np.float32))


# -- PLY -------------------------------------------------------------------------

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str):
    with open(path, "rb") as f:
        data = f.read()
    name = os.path.splitext(os.path.basename(path))[0]
    if not data.startswith(b"ply"):
        raise ValueError(f"{path}: not a PLY file")
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: unterminated PLY header")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[data.find(b"\n", end) + 1:]

    fmt = "ascii"
    elements: List[Tuple[str, int, List[Tuple[str, str, str]]]] = []
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and len(parts) >= 3:
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list" and len(parts) >= 5:
                elements[-1][2].append((parts[4], "list",
                                        parts[2] + ":" + parts[3]))
            elif len(parts) >= 3:
                elements[-1][2].append((parts[2], "scalar", parts[1]))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt!r}")

    parsed: Dict[str, Dict[str, np.ndarray]] = {}
    offset = 0
    ascii_rows = body.decode("ascii", errors="replace").split("\n") \
        if fmt == "ascii" else None
    row_at = 0
    for ename, count, props in elements:
        cols: Dict[str, list] = {p[0]: [] for p in props}
        if fmt == "ascii":
            for _ in range(count):
                vals = ascii_rows[row_at].split()
                row_at += 1
                k = 0
                for pname, kind, ptype in props:
                    if kind == "list":
                        ln = int(float(vals[k])); k += 1
                        cols[pname].append(
                            [float(v) for v in vals[k:k + ln]])
                        k += ln
                    else:
                        cols[pname].append(float(vals[k])); k += 1
        else:
            fixed = all(kind != "list" for _, kind, _ in props)
            if fixed:
                dt = np.dtype([(p[0], "<" + _PLY_DTYPES[p[2]])
                               for p in props])
                arr = np.frombuffer(body, dt, count, offset)
                offset += dt.itemsize * count
                for pname, _, _ in props:
                    cols[pname] = arr[pname]
            else:
                for _ in range(count):
                    for pname, kind, ptype in props:
                        if kind == "list":
                            ct, it = ptype.split(":")
                            cdt = np.dtype("<" + _PLY_DTYPES[ct])
                            idt = np.dtype("<" + _PLY_DTYPES[it])
                            ln = int(np.frombuffer(body, cdt, 1, offset)[0])
                            offset += cdt.itemsize
                            cols[pname].append(np.frombuffer(
                                body, idt, ln, offset).astype(np.int64))
                            offset += idt.itemsize * ln
                        else:
                            sdt = np.dtype("<" + _PLY_DTYPES[ptype])
                            cols[pname].append(
                                float(np.frombuffer(body, sdt, 1, offset)[0]))
                            offset += sdt.itemsize
        parsed[ename] = {k: v for k, v in cols.items()}

    if "vertex" not in parsed or "face" not in parsed:
        raise ValueError(f"{path}: PLY needs vertex and face elements")
    v = parsed["vertex"]
    pos = np.stack([np.asarray(v[c], np.float32)
                    for c in ("x", "y", "z")], axis=1)
    nv = pos.shape[0]

    def opt3(cs, scale=1.0):
        if all(c in v for c in cs):
            return np.stack([np.asarray(v[c], np.float32)
                             for c in cs], axis=1) * scale
        return None

    normals = opt3(("nx", "ny", "nz"))
    # color scaling comes from the DECLARED property dtype, not the
    # observed value range: a uchar-colored near-black mesh (all channels
    # <= 1) must still divide by 255, and float colors legitimately > 1.0
    # must not (advisor round-4 finding)
    vprops = {p[0]: p[2] for _en, _ct, _props in elements
              for p in _props if _en == "vertex"}
    ctype = _PLY_DTYPES.get(vprops.get("red", "float"), "f4")
    cscale = {"u1": 1.0 / 255.0, "i1": 1.0 / 127.0,
              "u2": 1.0 / 65535.0, "i2": 1.0 / 32767.0,
              "u4": 1.0 / 4294967295.0, "i4": 1.0 / 2147483647.0}.get(
                  ctype, 1.0)
    colors = opt3(("red", "green", "blue"), cscale)
    uvs = None
    for ua, va_ in (("u", "v"), ("s", "t")):
        if ua in v and va_ in v:
            uvs = np.stack([np.asarray(v[ua], np.float32),
                            np.asarray(v[va_], np.float32)], axis=1)
            break

    fkey = next((k for k in ("vertex_indices", "vertex_index")
                 if k in parsed["face"]), None)
    if fkey is None:
        raise ValueError(f"{path}: face element has no vertex index list")
    idx: List[int] = []
    for poly in parsed["face"][fkey]:
        p = np.asarray(poly, np.int64)
        for k in range(1, len(p) - 1):       # fan triangulation
            idx.extend((int(p[0]), int(p[k]), int(p[k + 1])))
    indices = np.asarray(idx, np.int32)
    if indices.size == 0:
        raise ValueError(f"{path}: no triangles parsed")
    if indices.min() < 0 or indices.max() >= nv:
        raise ValueError(f"{path}: face index out of range")

    if normals is None:
        # area-weighted smooth normals over shared vertices
        tri = indices.reshape(-1, 3)
        fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]],
                      pos[tri[:, 2]] - pos[tri[:, 0]])
        normals = np.zeros((nv, 3), np.float32)
        for c in range(3):
            np.add.at(normals, tri[:, c], fn)
        ln = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = (normals / np.maximum(ln, 1e-12)).astype(np.float32)

    mesh = Mesh(positions=pos, indices=indices, normals=normals,
                colors=colors, uvs=uvs, name=name)
    return _model(mesh, name)
