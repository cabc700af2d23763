"""The process-wide registry of metric sources and their Prometheus text
exposition (the JAX package's `obs/registry.py`).

An engine or the check service registers a zero-argument provider (its bound `metrics()` method)
under a source name ("resident", "frontier", "simulation"); `collect()` calls
every live provider and returns `{source: metrics dict}`. Providers are held
through weak references, so a registered engine is never kept alive by the
registry, and dead sources are pruned on every `collect()`. A provider that
raises is reported as `{"scrape_error": 1}` instead of failing the scrape.

`render_prometheus` turns `{source: metrics dict}` into the text format the
service's `GET /metrics` serves. Metric values may be numbers, bools (0/1),
None (skipped), nested dicts (flattened with `_`), lists of numbers (one
line per index) or `LogHistogram`s (native `_bucket` / `_sum` / `_count`
lines).
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


class LogHistogram:
    """A bounded histogram over geometric buckets `lo * factor^i` up to
    `hi`, plus +Inf, rendered as a Prometheus histogram. `observe` is a few
    adds and a scan of a few dozen bounds."""

    def __init__(self, lo: float = 0.125, hi: float = 8192.0, factor: float = 2.0):
        if not (lo > 0 and hi > lo and factor > 1):
            raise ValueError(f"bad histogram bounds lo={lo} hi={hi} factor={factor}")
        self.bounds: list = []
        b = lo
        while b <= hi * (1 + 1e-12):
            self.bounds.append(b)
            b *= factor
        self.counts = [0] * (len(self.bounds) + 1)  # [-1] is +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def render(self, name: str) -> list:
        """Prometheus text lines for this histogram under `name`."""
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{name}_bucket{{le="{_num(float(b))}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {self.count}')
        lines.append(f"{name}_sum {_num(self.sum)}")
        lines.append(f"{name}_count {self.count}")
        return lines


def flatten_metrics(d: dict, prefix: str = "") -> dict:
    """Nested dicts flattened to `a_b_c -> value`: bools become 0/1, None
    and non-numeric leaves are dropped, numeric lists and LogHistograms are
    kept as they are."""
    out: dict = {}
    for k, v in (d or {}).items():
        key = f"{prefix}{_sanitize(k)}"
        if isinstance(v, dict):
            out.update(flatten_metrics(v, prefix=key + "_"))
        elif isinstance(v, bool):
            out[key] = int(v)
        elif isinstance(v, (int, float, LogHistogram)):
            out[key] = v
        elif isinstance(v, (list, tuple)) and all(
            isinstance(x, (int, float)) and not isinstance(x, bool) for x in v
        ):
            out[key] = list(v)
    return out


def render_prometheus(groups: dict, prefix: str = "stateright") -> str:
    """Prometheus text exposition of `{source: metrics dict}`: every metric
    a gauge named `<prefix>_<source>_<key>`, histograms as histograms."""
    lines: list[str] = []
    for source in sorted(groups):
        flat = flatten_metrics(groups[source])
        src = _sanitize(source)
        for key in sorted(flat):
            name = f"{prefix}_{src}_{key}"
            value = flat[key]
            if isinstance(value, LogHistogram):
                lines.extend(value.render(name))
                continue
            lines.append(f"# TYPE {name} gauge")
            if isinstance(value, list):
                lines.extend(f'{name}{{index="{i}"}} {_num(x)}' for i, x in enumerate(value))
            else:
                lines.append(f"{name} {_num(value)}")
    return "\n".join(lines) + "\n"


def _num(x) -> str:
    return repr(x) if isinstance(x, float) else str(x)


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

    def sources(self) -> list:
        """The names of the live sources, sorted."""
        with self._lock:
            return sorted(k for k, v in self._sources.items() if self._alive(v))

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

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
