"""Input state tracking (reference: Application/Input.{h,cpp}).

Headless-friendly: a frontend (or test) feeds events; consumers query
down/pressed/released/repeat + mouse delta/scroll, with UI-capture gating.
"""

from __future__ import annotations

from typing import Set, Tuple

from trident.core.events import (
    Event,
    KeyPressedEvent,
    KeyReleasedEvent,
    MouseButtonPressedEvent,
    MouseButtonReleasedEvent,
    MouseMovedEvent,
    MouseScrolledEvent,
)


class Input:
    _instance = None

    def __init__(self) -> None:
        self._down: Set[int] = set()
        self._pressed: Set[int] = set()
        self._released: Set[int] = set()
        self._repeat: Set[int] = set()
        self._mouse_down: Set[int] = set()
        self._mouse_pressed: Set[int] = set()
        self._mouse_released: Set[int] = set()
        self._mouse_pos: Tuple[float, float] = (0.0, 0.0)
        self._mouse_prev: Tuple[float, float] = (0.0, 0.0)
        self._scroll: Tuple[float, float] = (0.0, 0.0)
        self.ui_capturing_keyboard = False
        self.ui_capturing_mouse = False

    @classmethod
    def get(cls) -> "Input":
        if cls._instance is None:
            cls._instance = Input()
        return cls._instance

    # -- frame lifecycle ----------------------------------------------------------
    def begin_frame(self) -> None:
        pass  # the prev-position snapshot lives in end_frame: events are
              # posted BETWEEN frames, so snapshotting here (after they
              # arrived) would zero every frame's mouse_delta

    def end_frame(self) -> None:
        self._pressed.clear()
        self._released.clear()
        self._repeat.clear()
        self._mouse_pressed.clear()
        self._mouse_released.clear()
        self._scroll = (0.0, 0.0)
        self._mouse_prev = self._mouse_pos

    # -- event feed ------------------------------------------------------------------
    def on_event(self, event: Event) -> None:
        if isinstance(event, KeyPressedEvent):
            if event.repeat:
                self._repeat.add(event.key)
            elif event.key not in self._down:
                self._pressed.add(event.key)
            self._down.add(event.key)
        elif isinstance(event, KeyReleasedEvent):
            self._down.discard(event.key)
            self._released.add(event.key)
        elif isinstance(event, MouseMovedEvent):
            self._mouse_pos = (event.x, event.y)
        elif isinstance(event, MouseScrolledEvent):
            self._scroll = (self._scroll[0] + event.dx, self._scroll[1] + event.dy)
        elif isinstance(event, MouseButtonPressedEvent):
            if event.button not in self._mouse_down:
                self._mouse_pressed.add(event.button)
            self._mouse_down.add(event.button)
        elif isinstance(event, MouseButtonReleasedEvent):
            self._mouse_down.discard(event.button)
            self._mouse_released.add(event.button)

    # -- queries (UI capture gates keyboard/mouse like the reference) ---------------
    def key_down(self, key: int) -> bool:
        return not self.ui_capturing_keyboard and key in self._down

    def key_pressed(self, key: int) -> bool:
        return not self.ui_capturing_keyboard and key in self._pressed

    def key_released(self, key: int) -> bool:
        return not self.ui_capturing_keyboard and key in self._released

    def key_repeated(self, key: int) -> bool:
        return not self.ui_capturing_keyboard and key in self._repeat

    def mouse_down(self, button: int) -> bool:
        return not self.ui_capturing_mouse and button in self._mouse_down

    def mouse_pressed(self, button: int) -> bool:
        return not self.ui_capturing_mouse and button in self._mouse_pressed

    def mouse_released(self, button: int) -> bool:
        return not self.ui_capturing_mouse and button in self._mouse_released

    @property
    def mouse_position(self) -> Tuple[float, float]:
        return self._mouse_pos

    @property
    def mouse_delta(self) -> Tuple[float, float]:
        return (self._mouse_pos[0] - self._mouse_prev[0],
                self._mouse_pos[1] - self._mouse_prev[1])

    @property
    def scroll(self) -> Tuple[float, float]:
        return self._scroll
