"""Minimal Prometheus client: counters, gauges, histograms with labels,
text exposition format, and a per-process default registry.

Mirrors the reference's metric families (`weed/stats/metrics.go:33-400`):
`SeaweedFS_{master,volume,filer,s3}_request_total`, `*_request_seconds`
histograms, volume/disk gauges. Exposed on each server's `/metrics`.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable

DEFAULT_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Captured when the stats layer first loads (servers import it at boot):
# exported as SeaweedFS_process_start_time_seconds so the history ring and
# cluster.top can tell a restarted process (counters back at zero) from a
# stalled one, and render uptime.
PROCESS_START_TIME = time.time()


def _escape_label_value(value) -> str:
    """Prometheus text-format label escaping: backslash, double-quote and
    newline must be escaped or the exposition line is unparseable."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_value(v: float) -> str:
    """Exposition value at full precision: '{:g}' clips to 6 significant
    digits, which truncates big byte counters / unix-time gauges (a 1.7e9
    start-time gauge rounded ~700s into the future, and a clipped counter
    reads flat between scrapes, so rate() = 0). Integers render exactly;
    other floats via repr (shortest round-trip form, what Prometheus's own
    Go client emits)."""
    v = float(v)
    return str(int(v)) if v.is_integer() else repr(v)


def _fmt_labels(label_names: tuple, label_values: tuple, extra: str = "") -> str:
    pairs = [
        '{}="{}"'.format(k, _escape_label_value(v))
        for k, v in zip(label_names, label_values)
    ]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str, label_names: Iterable[str] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def samples(self) -> list[tuple]:
        """(sample name, label values, extra label or None, value) for each
        line of the exposition, in its order; the extra label is a
        histogram bucket's ("le", bound) as the text writes it. `render`
        and the telemetry frames (stats/aggregate.py) both read it."""
        raise NotImplementedError

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for name, key, extra, val in self.samples():
            le = f'{extra[0]}="{extra[1]}"' if extra else ""
            out.append(f"{name}{_fmt_labels(self.label_names, key, le)} {_fmt_value(val)}")
        return out


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_text="", label_names=()):
        super().__init__(name, help_text, label_names)
        self._values: dict[tuple, float] = {}

    def labels(self, *values) -> "_CounterChild":
        return _CounterChild(self, tuple(str(v) for v in values))

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def _add(self, key: tuple, amount: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def samples(self) -> list[tuple]:
        """The family's series as the exposition lists them (see
        `_Metric.render`)."""
        with self._lock:
            items = sorted(self._values.items())
        return [(self.name, key, None, val) for key, val in items]


class _CounterChild:
    def __init__(self, parent: Counter, key: tuple):
        self._parent = parent
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._parent._add(self._key, amount)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_text="", label_names=()):
        super().__init__(name, help_text, label_names)
        self._values: dict[tuple, float] = {}
        self._fns: dict[tuple, callable] = {}

    def labels(self, *values) -> "_GaugeChild":
        return _GaugeChild(self, tuple(str(v) for v in values))

    def set(self, value: float) -> None:
        self.labels().set(value)

    def set_function(self, fn, *label_values) -> None:
        """Sample a callable at scrape time (for live gauges like disk free)."""
        with self._lock:
            self._fns[tuple(str(v) for v in label_values)] = fn

    def _set(self, key: tuple, value: float) -> None:
        with self._lock:
            self._values[key] = value

    def _add(self, key: tuple, amount: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def samples(self) -> list[tuple]:
        """The set values and the functions' answers (see
        `_Metric.render`)."""
        with self._lock:
            merged = dict(self._values)
            for key, fn in self._fns.items():
                try:
                    merged[key] = float(fn())
                except Exception:
                    pass
            items = sorted(merged.items())
        return [(self.name, key, None, val) for key, val in items]


class _GaugeChild:
    def __init__(self, parent: Gauge, key: tuple):
        self._parent = parent
        self._key = key

    def set(self, value: float) -> None:
        self._parent._set(self._key, value)

    def inc(self, amount: float = 1.0) -> None:
        self._parent._add(self._key, amount)

    def dec(self, amount: float = 1.0) -> None:
        self._parent._add(self._key, -amount)


# Exemplar source hook: () -> (trace_id, span_id) | None. Installed by
# stats.trace at import (this module must not import trace — trace
# imports it), so histograms can stamp the active trace id onto their
# latency samples without a dependency cycle.
_exemplar_source = None


def set_exemplar_source(fn) -> None:
    global _exemplar_source
    _exemplar_source = fn


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text="", label_names=(),
                 buckets=DEFAULT_BUCKETS, exemplars=False):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(sorted(buckets))
        self._les = tuple("{:g}".format(ub) for ub in self.buckets) + ("+Inf",)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}
        # exemplars: most recent (trace_id, value, ts) per upper bucket —
        # the join from a p99 row straight to the trace that landed there
        # (opt-in: only request-latency histograms pay the per-observe
        # source call; kernel histograms on the data plane do not)
        self.exemplars_enabled = bool(exemplars)
        self._exemplars: dict[tuple, dict[float, tuple]] = {}

    def labels(self, *values) -> "_HistogramChild":
        return _HistogramChild(self, tuple(str(v) for v in values))

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def _observe(self, key: tuple, value: float) -> None:
        ex = None
        if self.exemplars_enabled and _exemplar_source is not None:
            ctx = _exemplar_source()
            if ctx is not None:
                ex = (ctx[0], value, time.time())
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
            if ex is not None:
                for ub in self.buckets:
                    if value <= ub:
                        bound = ub
                        break
                else:
                    bound = float("inf")
                self._exemplars.setdefault(key, {})[bound] = ex

    def exemplars(self) -> list[dict]:
        """JSON-ready exemplar view: the freshest trace per (labels,
        upper bucket). `le` renders "+Inf" for the overflow bucket to
        stay JSON-safe."""
        with self._lock:
            items = [
                (key, sorted(per.items()))
                for key, per in self._exemplars.items()
            ]
        out = []
        for key, per in items:
            for bound, (tid, value, ts) in per:
                out.append({
                    "labels": dict(zip(self.label_names, key)),
                    "le": "+Inf" if bound == float("inf") else bound,
                    "trace_id": tid,
                    "value": round(value, 6),
                    "ts": round(ts, 3),
                })
        return out

    def samples(self) -> list[tuple]:
        """Each series' buckets, then its _sum and _count (see
        `_Metric.render`)."""
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
            totals = dict(self._totals)
        bucket, sum_, count = (self.name + s for s in ("_bucket", "_sum", "_count"))
        out = []
        for key, counts in items:
            for le, c in zip(self._les, (*counts, totals[key])):
                out.append((bucket, key, ("le", le), c))
            out.append((sum_, key, None, sums[key]))
            out.append((count, key, None, totals[key]))
        return out


class _HistogramChild:
    def __init__(self, parent: Histogram, key: tuple):
        self._parent = parent
        self._key = key

    def observe(self, value: float) -> None:
        self._parent._observe(self._key, value)

    def time(self):
        return _Timer(self)


class _Timer:
    def __init__(self, child: _HistogramChild):
        self._child = child

    def __enter__(self):
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._child.observe(time.monotonic() - self._start)
        return False


class Collector:
    """A scrape-time exposition source: fn() -> list of text-format lines.

    Servers whose series live OUTSIDE the registry's counters (the fastlane
    engine's C-side atomics, the master's topology tree) register one of
    these; the registry calls it on every render. `names` declares the
    metric families the fn produces so tooling (tools/check_metric_names.py)
    can lint the namespace without scraping a live server."""

    def __init__(self, fn, names: Iterable[str] = ()):
        self.fn = fn
        self.names = tuple(names)
        self.failing = False  # first failure per streak is logged


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Collector] = []
        self._lock = threading.Lock()

    def counter(self, name, help_text="", label_names=()) -> Counter:
        return self._get_or_create(Counter, name, help_text, label_names)

    def gauge(self, name, help_text="", label_names=()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, label_names)

    def histogram(
        self, name, help_text="", label_names=(), buckets=DEFAULT_BUCKETS,
        exemplars=False,
    ) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help_text, label_names, buckets,
                              exemplars=exemplars)
                self._metrics[name] = m
            if not isinstance(m, Histogram):
                raise TypeError(f"{name} already registered as {type(m).__name__}")
            if m.buckets != tuple(sorted(buckets)):
                raise TypeError(
                    f"{name} already registered with buckets {m.buckets}, "
                    f"not {tuple(sorted(buckets))}"
                )
            if exemplars:  # any registrant opting in turns them on
                m.exemplars_enabled = True
            return m

    def _get_or_create(self, cls, name, help_text, label_names):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_text, label_names)
                self._metrics[name] = m
            if not isinstance(m, cls):
                raise TypeError(f"{name} already registered as {type(m).__name__}")
            return m

    def get(self, name: str) -> _Metric | None:
        """The registered metric of that family name, if any."""
        with self._lock:
            return self._metrics.get(name)

    def register_collector(self, fn, names: Iterable[str] = ()) -> Collector:
        """Attach a scrape-time line source (see Collector). Returns the
        handle to pass to unregister_collector — servers MUST unregister on
        stop or a fixture-churned process accumulates stale closures."""
        col = Collector(fn, names)
        with self._lock:
            self._collectors.append(col)
        return col

    def unregister_collector(self, col: Collector) -> None:
        with self._lock:
            if col in self._collectors:
                self._collectors.remove(col)

    def exemplars(self, family: str | None = None) -> dict[str, list[dict]]:
        """{family: [exemplar, ...]} for every exemplar-bearing histogram
        (served inside /debug/metrics/history — the Prometheus 0.0.4 text
        format /metrics serves has no exemplar syntax, and smuggling one
        in would break every parse_exposition consumer)."""
        with self._lock:
            hists = [
                m for m in self._metrics.values()
                if isinstance(m, Histogram) and m.exemplars_enabled
                and (family is None or m.name == family)
            ]
        out: dict[str, list[dict]] = {}
        for h in hists:
            ex = h.exemplars()
            if ex:
                out[h.name] = ex
        return out

    def metric_names(self) -> list[str]:
        """Every family name this registry can expose: registered metrics
        plus collector-declared names (the lint surface)."""
        with self._lock:
            names = list(self._metrics)
            for col in self._collectors:
                names.extend(col.names)
        return sorted(set(names))

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        for col in collectors:
            # a dying server's collector must not break /metrics — but a
            # silent swallow would erase whole families with no breadcrumb,
            # so the first failure per streak is logged (start_push_loop's
            # pattern)
            try:
                lines.extend(col.fn())
                col.failing = False
            except Exception as e:
                if not col.failing:
                    col.failing = True
                    from seaweedfs_tpu_torch.util import glog

                    glog.warning("metrics collector %s failed: %s",
                                 col.names[:1] or col.fn, e)
        return "\n".join(lines) + "\n"


_default = Registry()


_SAMPLE_RE = None  # compiled lazily: most processes never parse exposition


def parse_exposition(text: str):
    """Parse Prometheus text format -> list of (name, labels, value).

    The inverse of Registry.render, shared by `cluster.check` (scraping
    /metrics across the cluster), bench.py's fastlane summary, and tests.
    Unparseable lines are skipped, like Prometheus itself treats them."""
    import re

    global _SAMPLE_RE
    if _SAMPLE_RE is None:
        _SAMPLE_RE = (
            re.compile(r'^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$'),
            re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"'),
        )
    line_re, label_re = _SAMPLE_RE
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        if m is None:
            continue
        try:
            value = float(m.group(3))
        except ValueError:
            continue
        labels = {}
        if m.group(2):
            for lm in label_re.finditer(m.group(2)):
                # single-pass unescape: ordered str.replace would corrupt a
                # literal backslash followed by 'n' ("\\n" -> newline)
                labels[lm.group(1)] = re.sub(
                    r"\\(.)",
                    lambda e: "\n" if e.group(1) == "n" else e.group(1),
                    lm.group(2),
                )
        out.append((m.group(1), labels, value))
    return out


def default_registry() -> Registry:
    return _default


def start_push_loop(push_url: str, role: str, instance: str,
                    interval_sec: float = 15.0, stop_event=None):
    """Background push of the registry to a Prometheus push gateway
    (`weed/stats/metrics.go` LoopPushingMetric). Returns the thread."""
    import threading
    import time as _time
    import urllib.parse
    import urllib.request

    reg = default_registry()
    push_errors = reg.counter(
        "SeaweedFS_stats_push_errors_total",
        "failed pushes to the metrics gateway", ("role",),
    )
    url = (f"{push_url.rstrip('/')}/metrics/job/{role}"
           f"/instance/{urllib.parse.quote(instance, safe='')}")

    def push_once():
        body = reg.render().encode()
        from seaweedfs_tpu_torch.security import tls as _tls

        req = urllib.request.Request(url, data=body, method="PUT")
        req.add_header("Content-Type", "text/plain")
        ctx = _tls.client_context() if url.startswith("https:") else None
        urllib.request.urlopen(req, timeout=10, context=ctx).read()

    def loop():
        from seaweedfs_tpu_torch.util import glog

        failing_streak = 0
        while True:
            try:
                push_once()
                failing_streak = 0
            except Exception as e:
                push_errors.labels(role).inc()
                if failing_streak == 0:  # first failure per streak only
                    glog.warning("metrics push to %s failed: %s", url, e)
                failing_streak += 1
            if stop_event is not None:
                if stop_event.wait(interval_sec):
                    return
            else:
                _time.sleep(interval_sec)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t
