"""ctypes binding for the native asset-packing core (native/loader.cpp).

Builds the shared object on demand (g++ available in the image) and falls
back to the pure-Python loader when compilation or loading fails — the
Python and native paths produce identical ModelData (covered by tests).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from trident.core.log import get_logger

logger = get_logger("assets.native")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_SRC = os.path.abspath(os.path.join(_NATIVE_DIR, "loader.cpp"))
_SO = os.path.abspath(os.path.join(_NATIVE_DIR, "libttnative.so"))

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _SO],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception as exc:
        logger.warning("native loader build failed: %s", exc)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_SO) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
            if not _build():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as exc:
            logger.warning("native loader unavailable: %s", exc)
            _load_failed = True
            return None
        lib.tt_load_obj.restype = ctypes.c_void_p
        lib.tt_load_obj.argtypes = [ctypes.c_char_p]
        lib.tt_mesh_count.argtypes = [ctypes.c_void_p]
        lib.tt_material_count.argtypes = [ctypes.c_void_p]
        lib.tt_mesh_vertex_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tt_mesh_index_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tt_mesh_material.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tt_mesh_name.restype = ctypes.c_char_p
        lib.tt_mesh_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.tt_mesh_copy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     f32p, f32p, f32p, f32p, f32p, i32p]
        lib.tt_material_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int, f32p, f32p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.tt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def load_obj_native(path: str):
    """Native OBJ load → ModelData, or None when unavailable."""
    from trident.assets.model_loader import ModelData, TextureRef
    from trident.geometry.mesh import Material, Mesh

    lib = get_lib()
    if lib is None:
        return None
    handle = lib.tt_load_obj(path.encode())
    if not handle:
        return None
    try:
        data = ModelData()
        tex_index: dict = {}
        for i in range(lib.tt_material_count(handle)):
            base = np.zeros(4, np.float32)
            mr = np.zeros(2, np.float32)
            name = ctypes.create_string_buffer(256)
            tex = ctypes.create_string_buffer(1024)
            lib.tt_material_get(handle, i, base, mr, name, 256, tex, 1024)
            mat = Material(base_color=tuple(float(x) for x in base),
                           metallic=float(mr[0]), roughness=float(mr[1]),
                           name=name.value.decode())
            tex_path = tex.value.decode()
            if tex_path:
                if tex_path not in tex_index:
                    tex_index[tex_path] = len(data.textures)
                    data.textures.append(TextureRef(
                        path=os.path.normpath(tex_path),
                        name=os.path.basename(tex_path)))
                mat.base_color_texture = tex_index[tex_path]
            data.materials.append(mat)

        for i in range(lib.tt_mesh_count(handle)):
            v = lib.tt_mesh_vertex_count(handle, i)
            n_idx = lib.tt_mesh_index_count(handle, i)
            pos = np.empty((v, 3), np.float32)
            nrm = np.empty((v, 3), np.float32)
            tan = np.empty((v, 3), np.float32)
            bit = np.empty((v, 3), np.float32)
            uv = np.empty((v, 2), np.float32)
            idx = np.empty(n_idx, np.int32)
            lib.tt_mesh_copy(handle, i, pos.ravel(), nrm.ravel(), tan.ravel(),
                             bit.ravel(), uv.ravel(), idx)
            data.meshes.append(Mesh(
                pos, idx, normals=nrm, tangents=tan, bitangents=bit, uvs=uv,
                material_index=lib.tt_mesh_material(handle, i),
                name=lib.tt_mesh_name(handle, i).decode() or f"mesh{i}",
                spatial_sort=False))   # native loader already Morton-sorts
            data.instance_transforms.append(np.eye(4, dtype=np.float32))
        return data
    finally:
        lib.tt_free(handle)
