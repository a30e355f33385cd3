"""Telemetry: gauges / counters / timing samples with a pluggable sink
(a copy of ``nomad_tpu/utils/telemetry.py``; reference: armon/go-metrics as used throughout the server —
`metrics.MeasureSince` around every hot path, periodic gauge emitters at
nomad/server.go:292-305; the published-metric inventory lives in
website/source/docs/agent/telemetry.html.md)."""

from __future__ import annotations

import bisect
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class MetricsSink:
    """Sink interface (go-metrics MetricSink): statsite/statsd/datadog in
    the reference; in-memory + blackhole here, externals pluggable."""

    def set_gauge(self, key: str, value: float) -> None:
        raise NotImplementedError

    def incr_counter(self, key: str, value: float = 1.0) -> None:
        raise NotImplementedError

    def add_sample(self, key: str, value: float) -> None:
        raise NotImplementedError


class BlackholeSink(MetricsSink):
    def set_gauge(self, key, value):
        pass

    def incr_counter(self, key, value=1.0):
        pass

    def add_sample(self, key, value):
        pass


class _Aggregate:
    __slots__ = ("count", "sum", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def add(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def summary(self) -> Dict:
        mean = self.sum / self.count if self.count else 0.0
        return {"count": self.count, "sum": round(self.sum, 6),
                "min": round(self.min, 6), "max": round(self.max, 6),
                "mean": round(mean, 6)}


# Bucket upper bounds, 1-2.5-5 per decade: 10µs–60s for ms timings,
# extended through 1e7 so count-valued samples (asks per batch, rounds)
# don't all collapse into the +Inf bucket at north-star scale.
# Quantiles interpolate linearly inside a bucket, clamped to the
# observed min/max, so worst-case error is one bucket's width.
DEFAULT_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 25000.0, 60000.0,
    100000.0, 250000.0, 500000.0, 1000000.0, 2500000.0, 5000000.0,
    10000000.0,
)

# Exact-percentile window: while a key has seen ≤ this many samples the
# quantiles come from a sorted copy of the raw values (bench-grade
# fidelity for short runs); beyond it the histogram buckets take over.
EXACT_WINDOW = 256


class _Histogram(_Aggregate):
    """Sample aggregate with streaming p50/p95/p99: bucketed counts plus
    a bounded ring of raw samples for exact small-N quantiles."""

    __slots__ = ("bounds", "buckets", "ring")

    def __init__(self, bounds: tuple = DEFAULT_BUCKETS) -> None:
        super().__init__()
        self.bounds = bounds
        self.buckets = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self.ring: deque = deque(maxlen=EXACT_WINDOW)

    def add(self, v: float) -> None:
        super().add(v)
        self.buckets[bisect.bisect_left(self.bounds, v)] += 1
        self.ring.append(v)

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        if self.count <= len(self.ring):
            ordered = sorted(self.ring)
            idx = min(len(ordered) - 1, int(q * len(ordered)))
            return ordered[idx]
        # Bucket interpolation: walk cumulative counts to the target
        # rank, interpolate within the containing bucket's bounds.
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (rank - cum) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def summary(self) -> Dict:
        out = super().summary()
        out["p50"] = round(self.percentile(0.50), 6)
        out["p95"] = round(self.percentile(0.95), 6)
        out["p99"] = round(self.percentile(0.99), 6)
        return out


class InmemSink(MetricsSink):
    """Interval-ringed in-memory aggregation (go-metrics InmemSink), the
    default backing for agent-info / /v1/metrics."""

    def __init__(self, interval: float = 10.0, retain: int = 6):
        self.interval = interval
        self.retain = retain
        self._l = threading.Lock()
        self._intervals: List[Dict] = []
        # Process-lifetime monotonic totals, never reset by interval
        # rolls: counters as running sums, samples as [count, sum].
        # Prometheus rate()/increase() need monotonic series; the 10s
        # interval sums would reset faster than a typical scrape period
        # and silently drop most increments.
        self._counter_totals: Dict[str, float] = {}
        self._sample_totals: Dict[str, List[float]] = {}
        self._roll(time.time())

    def _roll(self, now: float) -> Dict:
        cur = {"start": now, "gauges": {}, "counters": {}, "samples": {}}
        self._intervals.append(cur)
        del self._intervals[:-self.retain]
        return cur

    def _current(self) -> Dict:
        now = time.time()
        cur = self._intervals[-1]
        if now - cur["start"] >= self.interval:
            cur = self._roll(now)
        return cur

    def set_gauge(self, key, value):
        with self._l:
            self._current()["gauges"][key] = value

    def incr_counter(self, key, value=1.0):
        with self._l:
            counters = self._current()["counters"]
            agg = counters.get(key)
            if agg is None:
                agg = counters[key] = _Aggregate()
            agg.add(value)
            self._counter_totals[key] = \
                self._counter_totals.get(key, 0.0) + value

    def add_sample(self, key, value):
        with self._l:
            # get-then-insert, not setdefault: a _Histogram carries a
            # 22-slot bucket list + ring, too heavy to build-and-discard
            # on every sample of an existing key.
            samples = self._current()["samples"]
            agg = samples.get(key)
            if agg is None:
                agg = samples[key] = _Histogram()
            # Totals live independently of the interval ring — a fresh
            # interval must not reset them.
            tot = self._sample_totals.get(key)
            if tot is None:
                tot = self._sample_totals[key] = [0, 0.0]
            agg.add(value)
            tot[0] += 1
            tot[1] += value

    def data(self) -> List[Dict]:
        """Recent intervals, aggregates summarized (InmemSink.Data)."""
        with self._l:
            out = []
            for iv in self._intervals:
                out.append({
                    "Start": iv["start"],
                    "Gauges": dict(iv["gauges"]),
                    "Counters": {k: v.summary()
                                 for k, v in iv["counters"].items()},
                    "Samples": {k: v.summary()
                                for k, v in iv["samples"].items()},
                })
            return out

    def latest(self) -> Dict:
        """Summary of only the newest interval (stats()'s hot call —
        avoids aggregating every retained interval under the lock),
        plus the process-lifetime monotonic totals for scrapers."""
        with self._l:
            iv = self._intervals[-1]
            return {
                "Start": iv["start"],
                "Gauges": dict(iv["gauges"]),
                "Counters": {k: v.summary() for k, v in iv["counters"].items()},
                "Samples": {k: v.summary() for k, v in iv["samples"].items()},
                "CounterTotals": dict(self._counter_totals),
                "SampleTotals": {k: (v[0], v[1])
                                 for k, v in self._sample_totals.items()},
            }


class Telemetry:
    """The measuring front end handed to subsystems
    (go-metrics Metrics object)."""

    def __init__(self, sink: Optional[MetricsSink] = None,
                 prefix: str = "nomad"):
        self.sink = sink if sink is not None else InmemSink()
        self.prefix = prefix

    def _key(self, key: str) -> str:
        return f"{self.prefix}.{key}" if self.prefix else key

    def set_gauge(self, key: str, value: float) -> None:
        self.sink.set_gauge(self._key(key), value)

    def incr_counter(self, key: str, value: float = 1.0) -> None:
        self.sink.incr_counter(self._key(key), value)

    def add_sample(self, key: str, value: float) -> None:
        self.sink.add_sample(self._key(key), value)

    def measure_since(self, key: str, start: float) -> None:
        """Record elapsed milliseconds (metrics.MeasureSince).  ``start``
        must come from ``time.perf_counter()`` — the same clock the
        tracing plane uses, so a timestamp can feed both a sample and a
        retroactive span."""
        self.sink.add_sample(self._key(key),
                             (time.perf_counter() - start) * 1000.0)

    class _Timer:
        def __init__(self, t: "Telemetry", key: str):
            self.t = t
            self.key = key

        def __enter__(self):
            self.start = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.t.measure_since(self.key, self.start)
            return False

    def measure(self, key: str) -> "Telemetry._Timer":
        return Telemetry._Timer(self, key)


NULL_TELEMETRY = Telemetry(sink=BlackholeSink())


# ---------------------------------------------------------------------------
# Prometheus text exposition (format 0.0.4) — /v1/metrics?format=prometheus
# ---------------------------------------------------------------------------

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(key: str) -> str:
    name = _PROM_NAME_RE.sub("_", key)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


def render_prometheus(latest: Dict) -> str:
    """Render an InmemSink.latest() summary as Prometheus text
    exposition: gauges as-is, counters as ``<name>_total``, samples as
    summaries with p50/p95/p99 quantile labels + ``_sum``/``_count``.

    Counters and summary ``_sum``/``_count`` come from the sink's
    process-lifetime monotonic totals (``CounterTotals`` /
    ``SampleTotals``), never the 10s interval aggregates — interval
    resets would be faster than a typical scrape period and rate()
    would silently drop most increments.  Quantiles are moment-in-time
    estimates from the newest interval, the standard summary shape."""
    lines: List[str] = []
    for key in sorted(latest.get("Gauges", ())):
        name = _prom_name(key)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_prom_value(latest['Gauges'][key])}")
    counter_totals = latest.get("CounterTotals") or {
        k: v.get("sum", 0.0) for k, v in latest.get("Counters", {}).items()}
    for key in sorted(counter_totals):
        name = _prom_name(key) + "_total"
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_prom_value(counter_totals[key])}")
    samples = latest.get("Samples", {})
    sample_totals = latest.get("SampleTotals") or {}
    # Union of keys: a key whose interval rolled quiet still has totals,
    # and its _sum/_count series must not go stale — only the quantile
    # estimates (interval-local by design) may be absent.
    for key in sorted(set(samples) | set(sample_totals)):
        agg = samples.get(key, {})
        name = _prom_name(key)
        lines.append(f"# TYPE {name} summary")
        for q, field_name in (("0.5", "p50"), ("0.95", "p95"),
                              ("0.99", "p99")):
            if field_name in agg:
                lines.append(f'{name}{{quantile="{q}"}} '
                             f"{_prom_value(agg[field_name])}")
        count, total = sample_totals.get(
            key, (agg.get("count", 0), agg.get("sum", 0.0)))
        lines.append(f"{name}_sum {_prom_value(total)}")
        lines.append(f"{name}_count {int(count)}")
    return "\n".join(lines) + "\n"
