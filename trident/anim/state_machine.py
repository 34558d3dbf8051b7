"""Animation state machine: typed parameters, layers, states, transitions.

Reference: Animation/AnimationStateMachine.{h,cpp} — Unity-style: parameters
(Float/Bool/Int/Trigger), layers with weight/additive/bone masks, states
owning blend-node roots, transitions with exit time + fade duration +
comparison conditions; produces the final skinning palette.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

from trident.anim.blend_tree import BlendNode, EvalContext
from trident.anim.data import Skeleton
from trident.anim.pose import (
    Pose,
    additive_pose,
    blend_pose,
    compose_skinning_matrices,
)


class ParameterType(Enum):
    FLOAT = 0
    BOOL = 1
    INT = 2
    TRIGGER = 3


class Comparison(Enum):
    GREATER = 0
    LESS = 1
    EQUALS = 2
    NOT_EQUALS = 3
    TRIGGERED = 4


@dataclass
class Condition:
    parameter: str
    comparison: Comparison
    threshold: float = 0.0


@dataclass
class Transition:
    source: str
    target: str
    conditions: List[Condition] = field(default_factory=list)
    has_exit_time: bool = False
    exit_time: float = 1.0          # normalized state time
    fade_duration: float = 0.2      # seconds


@dataclass
class State:
    name: str
    root: BlendNode


class Layer:
    def __init__(self, name: str, weight: float = 1.0, additive: bool = False,
                 mask: Optional[np.ndarray] = None):
        self.name = name
        self.weight = weight
        self.additive = additive
        self.mask = mask
        self.states: Dict[str, State] = {}
        self.transitions: List[Transition] = []
        self.current: Optional[str] = None
        self.current_time = 0.0
        # crossfade state
        self.fading_from: Optional[str] = None
        self.fade_elapsed = 0.0
        self.fade_duration = 0.0

    def add_state(self, state: State, default: bool = False) -> None:
        self.states[state.name] = state
        if default or self.current is None:
            self.current = state.name

    def add_transition(self, transition: Transition) -> None:
        self.transitions.append(transition)


class AnimationStateMachine:
    def __init__(self, skeleton: Skeleton):
        self.skeleton = skeleton
        self.parameters: Dict[str, float] = {}
        self.parameter_types: Dict[str, ParameterType] = {}
        self.layers: List[Layer] = []
        self._bind = Pose.bind(skeleton)
        self._palette = np.tile(np.eye(4, dtype=np.float32), (len(skeleton), 1, 1))

    # -- parameters -------------------------------------------------------------
    def add_parameter(self, name: str, ptype: ParameterType, value: float = 0.0) -> None:
        self.parameter_types[name] = ptype
        self.parameters[name] = value

    def set_float(self, name: str, value: float) -> None:
        self.parameters[name] = float(value)

    def set_bool(self, name: str, value: bool) -> None:
        self.parameters[name] = 1.0 if value else 0.0

    def set_int(self, name: str, value: int) -> None:
        self.parameters[name] = float(value)

    def set_trigger(self, name: str) -> None:
        self.parameters[name] = 1.0

    def reset_trigger(self, name: str) -> None:
        self.parameters[name] = 0.0

    # -- structure ---------------------------------------------------------------
    def add_layer(self, layer: Layer) -> Layer:
        self.layers.append(layer)
        return layer

    # -- evaluation ---------------------------------------------------------------
    def _condition_met(self, cond: Condition) -> bool:
        v = self.parameters.get(cond.parameter, 0.0)
        if cond.comparison == Comparison.GREATER:
            return v > cond.threshold
        if cond.comparison == Comparison.LESS:
            return v < cond.threshold
        if cond.comparison == Comparison.EQUALS:
            return abs(v - cond.threshold) < 1e-6
        if cond.comparison == Comparison.NOT_EQUALS:
            return abs(v - cond.threshold) >= 1e-6
        return v >= 0.5  # TRIGGERED

    def _maybe_transition(self, layer: Layer, dt: float) -> None:
        if layer.current is None:
            return
        state = layer.states[layer.current]
        for tr in layer.transitions:
            if tr.source not in ("*", layer.current):
                continue
            if tr.target not in layer.states:
                continue
            if tr.has_exit_time:
                # normalized exit time against the root clip if known
                duration = getattr(getattr(state.root, "clip", None), "duration", 0.0)
                if duration > 0 and layer.current_time < tr.exit_time * duration:
                    continue
            if not all(self._condition_met(c) for c in tr.conditions):
                continue
            # consume triggers
            for c in tr.conditions:
                if self.parameter_types.get(c.parameter) == ParameterType.TRIGGER:
                    self.reset_trigger(c.parameter)
            layer.fading_from = layer.current
            layer.fade_elapsed = 0.0
            layer.fade_duration = max(tr.fade_duration, 0.0)
            layer.current = tr.target
            layer.current_time = 0.0
            layer.states[tr.target].root.reset()
            return

    def update(self, dt: float) -> np.ndarray:
        """Advance all layers and return the (B,4,4) skinning palette."""
        ctx = EvalContext(self.skeleton, self.parameters, self._bind)
        final: Optional[Pose] = None
        for layer in self.layers:
            self._maybe_transition(layer, dt)
            if layer.current is None:
                continue
            layer.current_time += dt
            pose = layer.states[layer.current].root.evaluate(ctx, dt)
            if layer.fading_from is not None and layer.fade_duration > 0:
                layer.fade_elapsed += dt
                f = min(layer.fade_elapsed / layer.fade_duration, 1.0)
                prev = layer.states[layer.fading_from].root.evaluate(ctx, 0.0)
                pose = blend_pose(prev, pose, f)
                if f >= 1.0:
                    layer.fading_from = None
            if final is None:
                final = pose
            elif layer.additive:
                final = additive_pose(final, pose, self._bind, layer.weight, layer.mask)
            else:
                final = blend_pose(final, pose, layer.weight, layer.mask)
        if final is None:
            final = self._bind
        self._palette = compose_skinning_matrices(final, self.skeleton)
        return self._palette

    def copy_pose(self, out: np.ndarray) -> None:
        np.copyto(out, self._palette)

    @property
    def palette(self) -> np.ndarray:
        return self._palette

    def copy(self) -> "AnimationStateMachine":
        """Shallow-structure copy for play-mode cloning (states share clip
        data; runtime clocks reset)."""
        sm = AnimationStateMachine(self.skeleton)
        sm.parameters = dict(self.parameters)
        sm.parameter_types = dict(self.parameter_types)
        for layer in self.layers:
            nl = Layer(layer.name, layer.weight, layer.additive, layer.mask)
            for name, st in layer.states.items():
                nl.add_state(State(name, st.root.copy()), default=(name == layer.current))
            nl.transitions = list(layer.transitions)
            sm.layers.append(nl)
        return sm
