"""Inspector-equivalent component editing (InspectorPanel.cpp analogue):
validated field get/set, schemas, dict round-trip."""

import numpy as np
import pytest

from trident.ecs.components import (
    LightComponent, LightType, MeshComponent, TagComponent,
    TransformComponent,
)
from trident.ecs.inspect import (
    apply_component, component_schema, component_type, get_field,
    list_entity, serialize_component, set_field,
)
from trident.ecs.registry import Registry


@pytest.fixture
def reg():
    r = Registry()
    e = r.create()
    r.add(e, TransformComponent())
    r.add(e, MeshComponent(mesh_index=3))
    r.add(e, LightComponent())
    r.add(e, TagComponent(tag="hero"))
    return r, e


def test_component_lookup_names():
    assert component_type("Transform") is TransformComponent
    assert component_type("transformcomponent") is TransformComponent
    with pytest.raises(KeyError):
        component_type("Nope")


def test_schema_kinds():
    s = component_schema("Transform")
    assert s["position"] == {"kind": "vector", "shape": (3,),
                             "default": [0.0, 0.0, 0.0], "editable": True}
    s = component_schema("Light")
    assert s["light_type"]["kind"] == "enum"
    assert "DIRECTIONAL" in s["light_type"]["choices"]
    s = component_schema("Animation")
    assert s["bone_matrices"]["editable"] is False


def test_set_vector_validates_shape_and_finiteness(reg):
    r, e = reg
    set_field(r, e, "Transform", "position", [1, 2, 3])
    assert get_field(r, e, "Transform", "position") == [1.0, 2.0, 3.0]
    t = r.get(e, TransformComponent)
    assert t.position.dtype == np.float32
    with pytest.raises(ValueError, match="shape"):
        set_field(r, e, "Transform", "position", [1, 2])
    with pytest.raises(ValueError, match="finite"):
        set_field(r, e, "Transform", "position", [1, float("nan"), 3])


def test_set_enum_by_name_and_value(reg):
    r, e = reg
    set_field(r, e, "Light", "light_type", "point")
    assert r.get(e, LightComponent).light_type == LightType.POINT
    set_field(r, e, "Light", "light_type", 0)
    assert r.get(e, LightComponent).light_type == LightType.DIRECTIONAL
    with pytest.raises(ValueError):
        set_field(r, e, "Light", "light_type", "spot")


def test_set_scalar_coercions(reg):
    r, e = reg
    assert set_field(r, e, "Mesh", "visible", "false") is False
    assert set_field(r, e, "Mesh", "mesh_index", "7") == 7
    assert set_field(r, e, "Light", "intensity", "2.5") == 2.5
    with pytest.raises(KeyError):
        set_field(r, e, "Mesh", "nonexistent", 1)


def test_opaque_fields_rejected(reg):
    r, e = reg
    from trident.ecs.components import AnimationComponent

    r.add(e, AnimationComponent())
    with pytest.raises(ValueError, match="runtime cache"):
        set_field(r, e, "Animation", "bone_matrices", [1])


def test_list_entity_and_roundtrip(reg):
    r, e = reg
    view = list_entity(r, e)
    assert view["Tag"] == {"tag": "hero"}
    assert view["Mesh"]["mesh_index"] == 3
    # serialize → mutate → apply restores exactly
    light = r.get(e, LightComponent)
    snap = serialize_component(light)
    light.intensity = 9.0
    light.light_type = LightType.POINT
    apply_component(light, snap)
    assert light.intensity == 1.0
    assert light.light_type == LightType.DIRECTIONAL
    assert serialize_component(light) == snap


def test_texture_path_edit_marks_dirty(reg):
    r, e = reg
    from trident.ecs.components import TextureComponent

    tc = r.add(e, TextureComponent(path="a.png"))
    tc.dirty = False
    set_field(r, e, "Texture", "path", "b.png")
    assert tc.dirty is True


def test_facade_inspector_surface():
    from trident.render.command import RenderCommand

    app = RenderCommand.init()
    try:
        reg = RenderCommand.get_registry()
        e = reg.create()
        reg.add(e, TransformComponent())
        RenderCommand.set_component_field(e, "Transform", "scale", [2, 2, 2])
        assert RenderCommand.get_component_field(e, "Transform", "scale") == [2, 2, 2]
        assert "position" in RenderCommand.component_schema("Transform")
        assert "Transform" in RenderCommand.inspect_entity(e)
    finally:
        RenderCommand.shutdown()
