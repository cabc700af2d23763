"""The process-wide registry of metric sources (the JAX package's
`obs/registry.py`, without the Prometheus exposition: the port has no HTTP
front end yet).

An engine registers a zero-argument provider (its bound `metrics()` method)
under a source name ("resident", "frontier", "simulation"); `collect()` calls
every live provider and returns `{source: metrics dict}`. Providers are held
through weak references, so a registered engine is never kept alive by the
registry, and dead sources are pruned on every `collect()`. A provider that
raises is reported as `{"scrape_error": 1}` instead of failing the scrape.
"""

from __future__ import annotations

import re
import threading
import weakref
from typing import Callable

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", str(name))
    if not name or not (name[0].isalpha() or name[0] == "_"):
        name = "_" + name
    return name


class CounterRegistry:
    """Weakly held named metric sources."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: dict[str, Callable] = {}

    def register(self, name: str, provider: Callable[[], dict]) -> str:
        """Register `provider` under `name` (suffixed 2, 3, ... while a live
        source holds the name); returns the name used. A bound method is
        held through `WeakMethod`."""
        if hasattr(provider, "__self__"):
            wm = weakref.WeakMethod(provider)

            def ref():
                m = wm()
                return m() if m is not None else None

            ref._weak = wm  # liveness probe for pruning
        else:
            def ref():
                return provider()

            ref._weak = None
        with self._lock:
            base, n = _sanitize(name), 1
            used = base
            while used in self._sources and self._alive(self._sources[used]):
                n += 1
                used = f"{base}{n}"
            self._sources[used] = ref
            return used

    @staticmethod
    def _alive(ref) -> bool:
        weak = getattr(ref, "_weak", None)
        return weak is None or weak() is not None

    def collect(self) -> dict:
        """{source: metrics dict} from every live provider."""
        with self._lock:
            items = list(self._sources.items())
        out: dict = {}
        dead: list[str] = []
        for name, ref in items:
            if not self._alive(ref):
                dead.append(name)
                continue
            try:
                m = ref()
            except Exception:  # noqa: BLE001 — one bad source must not fail the scrape
                m = {"scrape_error": 1}
            if m is None:
                dead.append(name)
                continue
            out[name] = m
        if dead:
            with self._lock:
                for name in dead:
                    self._sources.pop(name, None)
        return out


#: The process-wide registry.
REGISTRY = CounterRegistry()
