"""Entity/component registry.

Reference: ECS/Registry.h:76-206 — type-erased per-type storages keyed by
entity id, auto-attached UUIDComponent on create, and CopyFrom deep-clone
used for play-mode sandboxing. The Python analogue keeps dict-of-dict
storages; the renderer compiles these into packed draw arrays each frame
(see trident.render.frame), so per-entity dict lookups never enter jit.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple, Type, TypeVar

from trident.core.ids import new_uuid
from trident.ecs.components import UUIDComponent

Entity = int
T = TypeVar("T")


class Registry:
    def __init__(self) -> None:
        self._next_entity: Entity = 1
        self._alive: List[Entity] = []
        self._storages: Dict[Type, Dict[Entity, object]] = {}

    # -- entities -----------------------------------------------------------
    def create(self) -> Entity:
        entity = self._next_entity
        self._next_entity += 1
        self._alive.append(entity)
        self.add(entity, UUIDComponent(new_uuid()))
        return entity

    def destroy(self, entity: Entity) -> None:
        if entity in self._alive:
            self._alive.remove(entity)
        for storage in self._storages.values():
            storage.pop(entity, None)

    def alive(self) -> List[Entity]:
        return list(self._alive)

    def is_alive(self, entity: Entity) -> bool:
        return entity in self._alive

    def __len__(self) -> int:
        return len(self._alive)

    # -- components ---------------------------------------------------------
    def add(self, entity: Entity, component: T) -> T:
        self._storages.setdefault(type(component), {})[entity] = component
        return component

    def has(self, entity: Entity, component_type: Type[T]) -> bool:
        return entity in self._storages.get(component_type, {})

    def get(self, entity: Entity, component_type: Type[T]) -> T:
        try:
            return self._storages[component_type][entity]  # type: ignore[return-value]
        except KeyError:
            raise KeyError(f"entity {entity} has no {component_type.__name__}") from None

    def try_get(self, entity: Entity, component_type: Type[T]) -> Optional[T]:
        return self._storages.get(component_type, {}).get(entity)  # type: ignore[return-value]

    def remove(self, entity: Entity, component_type: Type[T]) -> None:
        self._storages.get(component_type, {}).pop(entity, None)

    def view(self, *component_types: Type) -> Iterator[Tuple[Entity, tuple]]:
        """Iterate (entity, components...) over entities having ALL types,
        in creation order."""
        if not component_types:
            return
        storages = [self._storages.get(t, {}) for t in component_types]
        for entity in self._alive:
            if all(entity in s for s in storages):
                yield entity, tuple(s[entity] for s in storages)

    def single(self, component_type: Type[T]) -> Optional[Tuple[Entity, T]]:
        for entity, (component,) in self.view(component_type):
            return entity, component  # type: ignore[return-value]
        return None

    # -- play-mode sandboxing ------------------------------------------------
    def copy_from(self, other: "Registry") -> None:
        """Deep-clone `other` into self (reference: Registry::CopyFrom,
        Registry.h:115-137). Components are cloned via their .copy()."""
        self._next_entity = other._next_entity
        self._alive = list(other._alive)
        self._storages = {}
        for ctype, storage in other._storages.items():
            self._storages[ctype] = {
                e: (c.copy() if hasattr(c, "copy") else c) for e, c in storage.items()
            }

    def clone(self) -> "Registry":
        out = Registry()
        out.copy_from(self)
        return out
