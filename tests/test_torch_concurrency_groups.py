"""The port's counterpart of ``tests/test_concurrency_groups.py`` (3 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name.

The reference's description:

Concurrency-group enforcement tests.

Analog of ray: python/ray/tests/test_concurrency_group.py — per-group
admission limits, @method(concurrency_group=...) annotations, .options()
overrides, and loud rejection of undeclared groups (the option used to be
accepted and silently ignored).
"""

import time

import pytest

import ray_tpu_torch

from tests.torch_fixtures import port_regular  # noqa: F401


def test_group_limits_enforced(port_regular):
    """Two groups saturate independently: "io" (cap 2) runs 2-wide while
    "compute" (cap 1) serializes, and neither blocks the other."""

    @ray_tpu_torch.remote(concurrency_groups={"io": 2, "compute": 1})
    class A:
        def __init__(self):
            self.peak = {"io": 0, "compute": 0}
            self.cur = {"io": 0, "compute": 0}
            import threading

            self.lock = threading.Lock()

        def _run(self, group, t):
            with self.lock:
                self.cur[group] += 1
                self.peak[group] = max(self.peak[group], self.cur[group])
            time.sleep(t)
            with self.lock:
                self.cur[group] -= 1
            return group

        @ray_tpu_torch.method(concurrency_group="io")
        def io_task(self, t=0.3):
            return self._run("io", t)

        @ray_tpu_torch.method(concurrency_group="compute")
        def compute_task(self, t=0.3):
            return self._run("compute", t)

        def peaks(self):
            return dict(self.peak)

    a = A.remote()
    ray_tpu_torch.get(a.peaks.remote(), timeout=60)  # wait for the actor to be up
    t0 = time.time()
    refs = [a.io_task.remote() for _ in range(4)]
    refs += [a.compute_task.remote() for _ in range(2)]
    out = ray_tpu_torch.get(refs, timeout=60)
    elapsed = time.time() - t0
    assert out == ["io"] * 4 + ["compute"] * 2
    peaks = ray_tpu_torch.get(a.peaks.remote(), timeout=30)
    assert peaks["io"] == 2  # saturated its cap, not beyond
    assert peaks["compute"] == 1  # serialized
    # 4 io tasks 2-wide = ~0.6s; 2 compute serial = ~0.6s, overlapping.
    assert elapsed < 2.5


def test_options_override_and_default_group(port_regular):
    @ray_tpu_torch.remote(concurrency_groups={"g": 1}, max_concurrency=4)
    class B:
        def tagged(self):
            import threading

            return threading.current_thread().name

        def plain(self, t=0.2):
            time.sleep(t)
            return "ok"

    b = B.remote()
    # Route an un-annotated method into group "g" via .options().
    assert ray_tpu_torch.get(
        b.tagged.options(concurrency_group="g").remote(), timeout=60
    )
    # Default-group methods run concurrently under max_concurrency.
    ray_tpu_torch.get(b.plain.remote(0.0), timeout=60)
    t0 = time.time()
    assert ray_tpu_torch.get([b.plain.remote() for _ in range(4)], timeout=60) == [
        "ok"
    ] * 4
    assert time.time() - t0 < 0.75


def test_undeclared_group_rejected(port_regular):
    @ray_tpu_torch.remote(concurrency_groups={"io": 2})
    class C:
        def f(self):
            return 1

    c = C.remote()
    with pytest.raises(ValueError, match="not declared"):
        c.f.options(concurrency_group="nope").remote()

    with pytest.raises(ValueError, match="declares concurrency_group"):

        @ray_tpu_torch.remote(concurrency_groups={"io": 2})
        class D:
            @ray_tpu_torch.method(concurrency_group="typo")
            def f(self):
                return 1

        D.remote()

    with pytest.raises(ValueError, match="positive int"):

        @ray_tpu_torch.remote(concurrency_groups={"io": 0})
        class E:
            def f(self):
                return 1

        E.remote()
