"""Cross-thread mutation detector — the validation-layer/TSan analogue.

The reference relies on Vulkan validation layers and single-threaded
editor access; here the equivalent hazard is a worker thread (video
encoder, dataset recorder, AI frame generator, file watcher) mutating the
ECS registry or renderer caches while the main loop packs draw arrays.
All shipped workers communicate through locked queues, but user Script
components and embedding code can spawn threads — this guard catches the
mistake deterministically instead of as a corrupted frame.

Enable with TRIDENT_THREAD_CHECKS=1 (or ``install_registry_guard()``):
every Registry mutation then asserts it runs on the owning thread. The
owner is the first mutating thread; ``rebind()`` transfers ownership
(used by Scene.play when handing the runtime registry to a loop).
Zero overhead when disabled — the guard methods are not installed at all.
"""

from __future__ import annotations

import os
import threading
from typing import Optional


class ThreadAffinityError(RuntimeError):
    pass


class ThreadGuard:
    """Asserts all guarded calls happen on one owning thread."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._owner: Optional[int] = None
        self._owner_name = ""

    def rebind(self) -> None:
        """Transfer ownership to the calling thread."""
        t = threading.current_thread()
        self._owner = t.ident
        self._owner_name = t.name

    def check(self, what: str = "mutation") -> None:
        t = threading.current_thread()
        if self._owner is None:
            self._owner = t.ident
            self._owner_name = t.name
            return
        if t.ident != self._owner:
            raise ThreadAffinityError(
                f"{self.name}: {what} from thread {t.name!r} but owned by "
                f"{self._owner_name!r} — route mutations through the owner "
                "thread (queues), or rebind() on an intentional handoff")


def checks_enabled() -> bool:
    return os.environ.get("TRIDENT_THREAD_CHECKS", "") not in ("", "0",
                                                               "false")


_installed = False
_active = False


def set_active(flag: bool) -> bool:
    """Toggle the installed guard at runtime (the method wrappers stay in
    place — they no-op when inactive). Returns the previous state. Lets
    tests that install the guard restore the process for later suites:
    installation itself is irreversible (methods are rebound)."""
    global _active
    prev = _active
    _active = bool(flag)
    return prev


def install_registry_guard() -> None:
    """Wrap Registry's mutating methods with a per-instance ThreadGuard.
    Idempotent; process-wide. Also (re)activates the checks."""
    global _installed
    if _installed:
        set_active(True)
        return
    from trident.ecs.registry import Registry

    def guard_of(reg) -> ThreadGuard:
        g = getattr(reg, "_thread_guard", None)
        if g is None:
            g = ThreadGuard(f"Registry@{id(reg):x}")
            reg._thread_guard = g
        return g

    for name in ("create", "destroy", "add", "remove", "copy_from"):
        orig = getattr(Registry, name, None)
        if orig is None:
            continue

        def wrapped(self, *a, _orig=orig, _what=name, **kw):
            if _active:
                guard_of(self).check(_what)
            return _orig(self, *a, **kw)

        setattr(Registry, name, wrapped)

    def rebind(self) -> None:
        guard_of(self).rebind()

    Registry.rebind_thread = rebind
    _installed = True
    set_active(True)


def maybe_install() -> None:
    if checks_enabled():
        install_registry_guard()
