"""Loader robustness: corrupted/truncated asset files must raise clean
Python exceptions — never crash, hang, or return garbage silently.
(The reference leans on Assimp's hardening; ADVICE r1 found a real OOB
read in the native OBJ path, so this class of input is tested on every
format we parse ourselves.)"""

import struct
import zlib

import numpy as np
import pytest


def _mutations(data: bytes, rng, n=12):
    """Truncations + byte flips at random offsets."""
    out = []
    for k in range(n):
        if k % 3 == 0 and len(data) > 4:
            out.append(data[: rng.integers(1, len(data))])
        else:
            b = bytearray(data)
            for _ in range(rng.integers(1, 8)):
                b[rng.integers(0, len(b))] = rng.integers(0, 256)
            out.append(bytes(b))
    return out


def _assert_clean(load, path):
    try:
        load(path)          # surviving a mutation is fine — crashing isn't
    except Exception:
        pass


def test_obj_fuzz(tmp_path, rng):
    from trident.assets.model_loader import load_model

    src = ("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
           "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1\n").encode()
    for i, m in enumerate(_mutations(src, rng)):
        p = tmp_path / f"f{i}.obj"
        p.write_bytes(m)
        _assert_clean(load_model, str(p))


def test_fbx_fuzz(tmp_path, rng):
    from test_fbx import _write_static_cube  # the test-suite FBX writer

    from trident.assets.model_loader import load_model

    good = tmp_path / "good.fbx"
    _write_static_cube(str(good))
    src = good.read_bytes()
    for i, m in enumerate(_mutations(src, rng)):
        p = tmp_path / f"f{i}.fbx"
        p.write_bytes(m)
        _assert_clean(load_model, str(p))


def test_dae_fuzz(tmp_path, rng):
    from trident.assets.model_loader import load_model

    src = (b'<?xml version="1.0"?><COLLADA xmlns="http://www.collada.org/'
           b'2005/11/COLLADASchema" version="1.4.1"><library_geometries>'
           b'<geometry id="g"><mesh><source id="p"><float_array id="pa" '
           b'count="9">0 0 0 1 0 0 0 1 0</float_array></source>'
           b'<vertices id="v"><input semantic="POSITION" source="#p"/>'
           b'</vertices><triangles count="1"><input semantic="VERTEX" '
           b'source="#v" offset="0"/><p>0 1 2</p></triangles></mesh>'
           b'</geometry></library_geometries></COLLADA>')
    for i, m in enumerate(_mutations(src, rng)):
        p = tmp_path / f"f{i}.dae"
        p.write_bytes(m)
        _assert_clean(load_model, str(p))


def test_ktx2_fuzz(tmp_path, rng):
    from trident.assets.ktx2 import load_ktx2_rgba8, write_ktx2

    p0 = tmp_path / "good.ktx2"
    write_ktx2(str(p0), np.zeros((8, 8, 4), np.uint8), scheme=3)
    src = p0.read_bytes()
    for i, m in enumerate(_mutations(src, rng)):
        p = tmp_path / f"f{i}.ktx2"
        p.write_bytes(m)
        _assert_clean(load_ktx2_rgba8, str(p))


def test_svg_fuzz(tmp_path, rng):
    from trident.io.svg import rasterize_svg_file

    src = (b'<svg xmlns="http://www.w3.org/2000/svg" width="16" height="16">'
           b'<path d="M2 2 C 4 1, 8 1, 14 14 A 3 3 0 1 1 2 14 Z" '
           b'fill="red" stroke="blue"/></svg>')
    for i, m in enumerate(_mutations(src, rng)):
        p = tmp_path / f"f{i}.svg"
        p.write_bytes(m)
        _assert_clean(rasterize_svg_file, str(p))


def test_gltf_fuzz(tmp_path, rng):
    import json

    from trident.assets.model_loader import load_model

    doc = {"asset": {"version": "2.0"},
           "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
           "accessors": [{"bufferView": 0, "componentType": 5126,
                          "count": 3, "type": "VEC3"}],
           "bufferViews": [{"buffer": 0, "byteLength": 36}],
           "buffers": [{"byteLength": 36,
                        "uri": "data:application/octet-stream;base64,"
                               + "AAAA" * 12}]}
    src = json.dumps(doc).encode()
    for i, m in enumerate(_mutations(src, rng)):
        p = tmp_path / f"f{i}.gltf"
        p.write_bytes(m)
        _assert_clean(load_model, str(p))


def test_stl_fuzz(tmp_path, rng):
    from trident.assets.model_loader import load_model

    # binary STL (with the evil "solid" prefix) + ASCII STL
    import struct as _s

    binary = bytearray(b"solid-prefix".ljust(80, b"\0"))
    binary += _s.pack("<I", 2)
    for k in range(2):
        binary += _s.pack("<3f", 0, 0, 1)
        for v in ([0, 0, k], [1, 0, k], [0, 1, k]):
            binary += _s.pack("<3f", *v)
        binary += _s.pack("<H", 0)
    ascii_src = (b"solid t\n facet normal 0 0 1\n  outer loop\n"
                 b"   vertex 0 0 0\n   vertex 1 0 0\n   vertex 0 1 0\n"
                 b"  endloop\n endfacet\nendsolid t\n")
    for i, m in enumerate(_mutations(bytes(binary), rng)
                          + _mutations(ascii_src, rng)):
        p = tmp_path / f"f{i}.stl"
        p.write_bytes(m)
        _assert_clean(load_model, str(p))


def test_ply_fuzz(tmp_path, rng):
    import struct as _s

    from trident.assets.model_loader import load_model

    ascii_src = (b"ply\nformat ascii 1.0\nelement vertex 3\n"
                 b"property float x\nproperty float y\nproperty float z\n"
                 b"element face 1\n"
                 b"property list uchar int vertex_indices\nend_header\n"
                 b"0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    header = (b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n"
              b"property float x\nproperty float y\nproperty float z\n"
              b"element face 1\n"
              b"property list uchar int vertex_indices\nend_header\n")
    body = b"".join(_s.pack("<3f", *v)
                    for v in ([0, 0, 0], [1, 0, 0], [0, 1, 0]))
    body += _s.pack("<B3i", 3, 0, 1, 2)
    for i, m in enumerate(_mutations(ascii_src, rng)
                          + _mutations(header + body, rng)):
        p = tmp_path / f"f{i}.ply"
        p.write_bytes(m)
        _assert_clean(load_model, str(p))
