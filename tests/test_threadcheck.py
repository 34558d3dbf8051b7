"""Cross-thread mutation detector (core/threadcheck.py — the
validation-layer/TSan analogue for the host-side engine state)."""

import threading

import pytest

from trident.core.threadcheck import (
    ThreadAffinityError, ThreadGuard, install_registry_guard)
from trident.ecs.components import TagComponent, TransformComponent
from trident.ecs.registry import Registry


@pytest.fixture(autouse=True)
def _restore_guard_state():
    """install_registry_guard is process-wide and irreversible (methods
    are rebound) — deactivate after each test so the rest of the suite
    (e.g. the viewer's lock-serialized HTTP threads) runs unguarded,
    unless the env opted in for the whole run."""
    yield
    from trident.core import threadcheck

    threadcheck.set_active(threadcheck.checks_enabled())


def _run_in_thread(fn):
    out = {}

    def runner():
        try:
            fn()
            out["error"] = None
        except Exception as exc:  # noqa: BLE001
            out["error"] = exc

    t = threading.Thread(target=runner, name="worker")
    t.start()
    t.join()
    return out["error"]


def test_guard_owns_first_thread_and_rejects_others():
    g = ThreadGuard("test")
    g.check()
    assert _run_in_thread(lambda: g.check()) is not None
    err = _run_in_thread(lambda: g.check("poke"))
    assert isinstance(err, ThreadAffinityError)
    assert "poke" in str(err)


def test_guard_rebind_transfers_ownership():
    g = ThreadGuard("test")
    g.check()

    def handoff():
        g.rebind()
        g.check()

    assert _run_in_thread(handoff) is None
    with pytest.raises(ThreadAffinityError):
        g.check()     # original thread no longer owns it


def test_registry_guard_catches_cross_thread_add():
    install_registry_guard()
    reg = Registry()
    e = reg.create()
    reg.add(e, TransformComponent())     # owner = this thread

    err = _run_in_thread(lambda: reg.add(e, TagComponent("bad")))
    assert isinstance(err, ThreadAffinityError)

    # reads stay unguarded (cheap, and the engine's readers are queue-fed)
    assert reg.get(e, TransformComponent) is not None

    # intentional handoff: rebind on the new thread, then mutate freely
    def handoff():
        reg.rebind_thread()
        reg.add(e, TagComponent("ok"))

    assert _run_in_thread(handoff) is None
