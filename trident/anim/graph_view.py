"""Animation graph introspection — the AnimationGraphPanel analogue.

The reference reserves an AnimationGraphPanel (Trident-Forge/src/Panels/
AnimationGraphPanel, mostly placeholder); here the live web viewer
(scripts/viewer.py /api/animgraph) renders a real one from this
serializer: layers with states / transitions / crossfade status, the
parameter table (editable through /api/anim_param), and each state's
blend-tree shape."""

from __future__ import annotations

from typing import Any, Dict

from trident.anim.blend_tree import (
    Blend2Node, BlendSpace1DNode, ClipNode,
)
from trident.anim.state_machine import AnimationStateMachine


def describe_node(node) -> Dict[str, Any]:
    """Recursive blend-tree shape (type + parameters + children)."""
    if isinstance(node, ClipNode):
        return {"type": "clip",
                "clip": getattr(node.clip, "name", "") or "<clip>",
                "looping": node.looping, "speed": node.speed,
                "time": round(float(node.time), 3)}
    if isinstance(node, Blend2Node):
        return {"type": "blend2", "parameter": node.weight_parameter,
                "children": [describe_node(node.a), describe_node(node.b)]}
    if isinstance(node, BlendSpace1DNode):
        return {"type": "blendspace1d", "parameter": node.parameter,
                "samples": [{"at": float(s.value),
                             "node": describe_node(s.node)}
                            for s in node.samples]}
    return {"type": type(node).__name__}


def describe_state_machine(sm: AnimationStateMachine) -> Dict[str, Any]:
    """JSON-ready graph: parameters, layers, states, transitions, and the
    LIVE runtime status (current state, normalized time, crossfade)."""
    params = [{"name": n, "type": sm.parameter_types[n].name.lower(),
               "value": float(v)} for n, v in sm.parameters.items()]
    layers = []
    for layer in sm.layers:
        states = []
        for name, st in layer.states.items():
            states.append({"name": name, "active": name == layer.current,
                           "tree": describe_node(st.root)})
        transitions = [{
            "source": t.source, "target": t.target,
            "has_exit_time": t.has_exit_time, "exit_time": t.exit_time,
            "fade_duration": t.fade_duration,
            "conditions": [{"parameter": c.parameter,
                            "comparison": c.comparison.name.lower(),
                            "threshold": float(c.threshold)}
                           for c in t.conditions],
        } for t in layer.transitions]
        layers.append({
            "name": layer.name, "weight": float(layer.weight),
            "additive": layer.additive,
            "current": layer.current,
            "current_time": round(float(layer.current_time), 3),
            "fading_from": layer.fading_from,
            "fade_elapsed": round(float(layer.fade_elapsed), 3),
            "fade_duration": float(layer.fade_duration),
            "states": states, "transitions": transitions,
        })
    return {"parameters": params, "layers": layers,
            "bones": len(sm.skeleton)}


def set_parameter(sm: AnimationStateMachine, name: str, value) -> None:
    """Type-dispatched parameter write (the panel's edit path)."""
    from trident.anim.state_machine import ParameterType

    ptype = sm.parameter_types.get(name)
    if ptype is None:
        raise KeyError(f"unknown animation parameter {name!r}")
    if ptype == ParameterType.TRIGGER:
        if value:
            sm.set_trigger(name)
        else:
            sm.reset_trigger(name)
    elif ptype == ParameterType.BOOL:
        sm.set_bool(name, bool(value))
    elif ptype == ParameterType.INT:
        sm.set_int(name, int(value))
    else:
        sm.set_float(name, float(value))
