"""COLLADA (.dae) import: geometry, materials, skins, animation channels.

The test writes real COLLADA 1.4 documents (the schema subset Blender and
Mixamo emit) and loads them through the public load_model path
(reference behavior: ModelLoader.cpp:27-38 via Assimp).
"""

import numpy as np
import pytest

from trident.assets.model_loader import load_model

_STATIC = """<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><up_axis>Z_UP</up_axis></asset>
  <library_effects>
    <effect id="fx-red"><profile_COMMON><technique sid="common">
      <lambert><diffuse><color>0.9 0.1 0.2 1</color></diffuse></lambert>
    </technique></profile_COMMON></effect>
  </library_effects>
  <library_materials>
    <material id="mat-red" name="red"><instance_effect url="#fx-red"/></material>
  </library_materials>
  <library_geometries>
    <geometry id="quadgeo" name="quad"><mesh>
      <source id="pos"><float_array id="pos-a" count="12">
        0 0 0  2 0 0  2 2 0  0 2 0</float_array>
        <technique_common><accessor source="#pos-a" count="4" stride="3">
          <param name="X" type="float"/><param name="Y" type="float"/>
          <param name="Z" type="float"/></accessor></technique_common>
      </source>
      <source id="nrm"><float_array id="nrm-a" count="3">0 0 1</float_array>
        <technique_common><accessor source="#nrm-a" count="1" stride="3"/>
        </technique_common></source>
      <source id="uvs"><float_array id="uvs-a" count="8">
        0 0  1 0  1 1  0 1</float_array>
        <technique_common><accessor source="#uvs-a" count="4" stride="2"/>
        </technique_common></source>
      <vertices id="verts"><input semantic="POSITION" source="#pos"/></vertices>
      <polylist material="symred" count="1">
        <input semantic="VERTEX" source="#verts" offset="0"/>
        <input semantic="NORMAL" source="#nrm" offset="1"/>
        <input semantic="TEXCOORD" source="#uvs" offset="2" set="0"/>
        <vcount>4</vcount>
        <p>0 0 0  1 0 1  2 0 2  3 0 3</p>
      </polylist>
    </mesh></geometry>
  </library_geometries>
  <library_visual_scenes>
    <visual_scene id="scene">
      <node id="quadnode" name="quadnode">
        <translate>1 0 0</translate>
        <instance_geometry url="#quadgeo">
          <bind_material><technique_common>
            <instance_material symbol="symred" target="#mat-red"/>
          </technique_common></bind_material>
        </instance_geometry>
      </node>
    </visual_scene>
  </library_visual_scenes>
  <scene><instance_visual_scene url="#scene"/></scene>
</COLLADA>
"""


def test_dae_static(tmp_path):
    p = tmp_path / "quad.dae"
    p.write_text(_STATIC)
    data = load_model(str(p))
    assert len(data.meshes) == 1
    mesh = data.meshes[0]
    assert mesh.triangle_count == 2
    assert mesh.positions.shape[0] == 4
    mat = data.materials[mesh.material_index]
    assert np.allclose(mat.base_color[:3], [0.9, 0.1, 0.2])
    # Z_UP fix + node translate both live in the instance transform
    inst = data.instance_transforms[0]
    world = (inst @ np.array([0, 0, 0, 1.0]))[:3]
    np.testing.assert_allclose(world, [1, 0, 0], atol=1e-6)
    # a Z-up point (0,0,1) maps to Y-up (0,1,0) after the axis fix
    up = (inst @ np.array([-1, 0, 1, 1.0]))[:3]
    np.testing.assert_allclose(up, [0, 1, 0], atol=1e-6)
    # V flipped
    assert set(np.round(mesh.uvs[:, 1], 3)) == {0.0, 1.0}


_SKINNED = """<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><up_axis>Y_UP</up_axis></asset>
  <library_geometries>
    <geometry id="stripgeo"><mesh>
      <source id="pos"><float_array id="pos-a" count="18">
        0 0 0  1 0 0  0 1 0  1 1 0  0 2 0  1 2 0</float_array>
        <technique_common><accessor source="#pos-a" count="6" stride="3"/>
        </technique_common></source>
      <vertices id="verts"><input semantic="POSITION" source="#pos"/></vertices>
      <triangles count="4">
        <input semantic="VERTEX" source="#verts" offset="0"/>
        <p>0 1 2  1 3 2  2 3 4  3 5 4</p>
      </triangles>
    </mesh></geometry>
  </library_geometries>
  <library_controllers>
    <controller id="stripskin"><skin source="#stripgeo">
      <bind_shape_matrix>1 0 0 0  0 1 0 0  0 0 1 0  0 0 0 1</bind_shape_matrix>
      <source id="joints"><Name_array id="joints-a" count="2">root tip</Name_array>
        <technique_common><accessor source="#joints-a" count="2" stride="1">
          <param name="JOINT" type="name"/></accessor></technique_common></source>
      <source id="binds"><float_array id="binds-a" count="32">
        1 0 0 0  0 1 0 0  0 0 1 0  0 0 0 1
        1 0 0 0  0 1 0 -1  0 0 1 0  0 0 0 1</float_array>
        <technique_common><accessor source="#binds-a" count="2" stride="16"/>
        </technique_common></source>
      <source id="wgt"><float_array id="wgt-a" count="2">1 0.5</float_array>
        <technique_common><accessor source="#wgt-a" count="2" stride="1"/>
        </technique_common></source>
      <joints>
        <input semantic="JOINT" source="#joints"/>
        <input semantic="INV_BIND_MATRIX" source="#binds"/>
      </joints>
      <vertex_weights count="6">
        <input semantic="JOINT" source="#joints" offset="0"/>
        <input semantic="WEIGHT" source="#wgt" offset="1"/>
        <vcount>1 1 2 2 1 1</vcount>
        <v>0 0  0 0  0 1 1 1  0 1 1 1  1 0  1 0</v>
      </vertex_weights>
    </skin></controller>
  </library_controllers>
  <library_animations>
    <animation id="a1">
      <source id="a1-t"><float_array id="a1-t-a" count="2">0 1</float_array>
        <technique_common><accessor source="#a1-t-a" count="2" stride="1"/>
        </technique_common></source>
      <source id="a1-v"><float_array id="a1-v-a" count="32">
        1 0 0 0  0 1 0 1  0 0 1 0  0 0 0 1
        0 -1 0 0  1 0 0 1  0 0 1 0  0 0 0 1</float_array>
        <technique_common><accessor source="#a1-v-a" count="2" stride="16"/>
        </technique_common></source>
      <sampler id="a1-s">
        <input semantic="INPUT" source="#a1-t"/>
        <input semantic="OUTPUT" source="#a1-v"/>
      </sampler>
      <channel source="#a1-s" target="tipnode/matrix"/>
    </animation>
  </library_animations>
  <library_visual_scenes>
    <visual_scene id="scene">
      <node id="rootnode" sid="root" type="JOINT">
        <node id="tipnode" sid="tip" type="JOINT">
          <translate>0 1 0</translate>
        </node>
      </node>
      <node id="stripnode">
        <instance_controller url="#stripskin"/>
      </node>
    </visual_scene>
  </library_visual_scenes>
  <scene><instance_visual_scene url="#scene"/></scene>
</COLLADA>
"""


def test_dae_skin_and_anim(tmp_path):
    p = tmp_path / "strip.dae"
    p.write_text(_SKINNED)
    data = load_model(str(p))
    assert len(data.meshes) == 1
    assert data.skeleton is not None and len(data.skeleton) == 2
    root, tip = data.skeleton.bones
    assert root.name == "root" and tip.parent == 0
    np.testing.assert_allclose(tip.local_bind[:3, 3], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(tip.inverse_bind[1, 3], -1, atol=1e-6)

    mesh = data.meshes[0]
    assert (mesh.bone_indices >= 0).any()
    mid = mesh.positions[:, 1] == 1.0            # blended row
    w = mesh.bone_weights[mid]
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-5)
    assert (np.abs(w - 0.5) < 1e-5).sum() >= 4   # 0.5/0.5 renormalized

    assert len(data.clips) == 1
    ch = data.clips[0].channels[0]
    assert ch.bone_name == "tip"
    assert data.clips[0].duration == pytest.approx(1.0)
    np.testing.assert_allclose(ch.positions[1], [0, 1, 0], atol=1e-6)
    # 90° about +z at t=1
    assert abs(ch.rotations[1, 0]) == pytest.approx(np.cos(np.pi / 4), abs=1e-5)


_ROTATE_ANIM = """<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <library_animations>
    <animation id="rz">
      <source id="rz-t"><float_array id="rz-t-a" count="2">0 1</float_array>
        <technique_common><accessor source="#rz-t-a" count="2" stride="1"/>
        </technique_common></source>
      <source id="rz-v"><float_array id="rz-v-a" count="2">0 90</float_array>
        <technique_common><accessor source="#rz-v-a" count="2" stride="1"/>
        </technique_common></source>
      <sampler id="rz-s">
        <input semantic="INPUT" source="#rz-t"/>
        <input semantic="OUTPUT" source="#rz-v"/>
      </sampler>
      <channel source="#rz-s" target="spin/rotationZ.ANGLE"/>
    </animation>
    <animation id="tx">
      <source id="tx-t"><float_array id="tx-t-a" count="2">0 1</float_array>
        <technique_common><accessor source="#tx-t-a" count="2" stride="1"/>
        </technique_common></source>
      <source id="tx-v"><float_array id="tx-v-a" count="2">0 5</float_array>
        <technique_common><accessor source="#tx-v-a" count="2" stride="1"/>
        </technique_common></source>
      <sampler id="tx-s">
        <input semantic="INPUT" source="#tx-t"/>
        <input semantic="OUTPUT" source="#tx-v"/>
      </sampler>
      <channel source="#tx-s" target="spin/translate.X"/>
    </animation>
  </library_animations>
  <library_visual_scenes>
    <visual_scene id="scene">
      <node id="spin" sid="spin" type="JOINT">
        <translate sid="translate">1 2 3</translate>
        <rotate sid="rotationZ">0 0 1 0</rotate>
      </node>
    </visual_scene>
  </library_visual_scenes>
  <scene><instance_visual_scene url="#scene"/></scene>
</COLLADA>
"""


def test_dae_rotate_and_component_channels(tmp_path):
    """SketchUp/3ds-Max style channels: single-axis rotationZ.ANGLE tracks
    must become quaternion keys (previously silently dropped → frozen
    rotation), and a stride-1 translate.X channel must keep the node's
    Y/Z instead of broadcasting X into all three components."""
    p = tmp_path / "spin.dae"
    p.write_text(_ROTATE_ANIM)
    data = load_model(str(p))
    assert len(data.clips) == 1
    ch = next(c for c in data.clips[0].channels if c.bone_name == "spin")

    # rotation: 0 -> 90 deg about Z => quat (cos45, 0, 0, sin45) at t=1
    assert ch.rotation_times.shape[0] == 2
    np.testing.assert_allclose(ch.rotations[0], [1, 0, 0, 0], atol=1e-6)
    s2 = np.sqrt(0.5)
    np.testing.assert_allclose(np.abs(ch.rotations[-1]), [s2, 0, 0, s2],
                               atol=1e-5)

    # translate.X: x animates 0 -> 5, y/z keep the node's 2/3
    np.testing.assert_allclose(ch.positions[0], [0, 2, 3], atol=1e-6)
    np.testing.assert_allclose(ch.positions[-1], [5, 2, 3], atol=1e-6)
    assert data.clips[0].duration == pytest.approx(1.0)
