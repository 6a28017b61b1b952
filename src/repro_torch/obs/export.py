"""Trace exporters: registry + Chrome/Perfetto and JSONL builtins (the
port's own copy of ``repro.obs.export``, in the same formats).

Mirrors the registry-first style of ``core/strategies.py`` /
``kernels/registry.py``: exporters are looked up by name so the launch
CLIs can source ``--trace-format`` choices live from the registry and
downstream code can plug in new sinks without touching this module:

    from repro_torch.obs import export as obs_export
    obs_export.register_exporter("my_sink", my_fn)   # fn(trace_dict, path)
    obs_export.export(tracer, "out.bin", format="my_sink")

Builtins:

* ``chrome`` — Chrome Trace Event JSON (the ``trace.json`` format
  Perfetto / ``chrome://tracing`` load directly): one phase-``X``
  complete event per span (``ts``/``dur`` in microseconds), one
  phase-``i`` instant event per tracer event, ``pid`` = the span's
  ``node`` attr (the paper's "node" — one pid lane per device) and
  ``tid`` = recording thread, with phase-``M`` metadata records naming
  both. Counters and tracer meta ride in ``otherData``.
* ``jsonl`` — one JSON object per line (header meta, then every span
  and event in recorded order, then a trailing counters record); the
  round-trippable form ``load_jsonl`` reads back for offline analysis.

Exporters receive the plain-data ``trace.to_dict()`` form, so anything
that quacks like it (e.g. ``load_jsonl``'s return value) re-exports.
"""
from __future__ import annotations

import json
from typing import Any, Dict

from repro_torch.core.strategies import Registry

EXPORTERS = Registry("trace exporter")


def register_exporter(name: str, fn, *, overwrite: bool = False):
    """Register ``fn(trace_dict, path)`` under ``name``."""
    return EXPORTERS.register(name, fn, overwrite=overwrite)


def names():
    return EXPORTERS.names()


def _as_dict(trace) -> Dict[str, Any]:
    if isinstance(trace, dict):
        return trace
    return trace.to_dict()


def export(trace, path: str, format: str = "chrome") -> str:
    """Write ``trace`` (a Tracer or a trace dict) to ``path``."""
    EXPORTERS.get(format)(_as_dict(trace), path)
    return path


# ---------------------------------------------------------------------------
# chrome: Chrome Trace Event format (Perfetto-loadable trace.json)
# ---------------------------------------------------------------------------

def _span_pid(span: Dict[str, Any]) -> int:
    node = span.get("attrs", {}).get("node", None)
    return int(node) if isinstance(node, (int, float)) and node >= 0 else 0


def export_chrome(trace: Dict[str, Any], path: str) -> None:
    events = []
    tids: Dict[str, int] = {}
    pids = set()

    def tid_of(thread: str) -> int:
        if thread not in tids:
            tids[thread] = len(tids) + 1
        return tids[thread]

    for s in trace.get("spans", ()):
        pid = _span_pid(s)
        pids.add(pid)
        events.append({
            "name": s["name"], "ph": "X", "pid": pid,
            "tid": tid_of(s.get("thread", "main")),
            "ts": round(s["t0"] * 1e6, 3),
            "dur": round((s["t1"] - s["t0"]) * 1e6, 3),
            "args": s.get("attrs", {}),
        })
    for e in trace.get("events", ()):
        pid = _span_pid(e)
        pids.add(pid)
        events.append({
            "name": e["name"], "ph": "i", "s": "t", "pid": pid,
            "tid": tid_of(e.get("thread", "main")),
            "ts": round(e["t"] * 1e6, 3),
            "args": e.get("attrs", {}),
        })
    for pid in sorted(pids):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"node {pid}"}})
    for thread, tid in tids.items():
        for pid in sorted(pids):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": thread}})
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"meta": trace.get("meta", {}),
                      "counters": trace.get("counters", {})},
    }
    with open(path, "w") as f:
        json.dump(doc, f)


# ---------------------------------------------------------------------------
# jsonl: line-per-record span log (round-trippable via load_jsonl)
# ---------------------------------------------------------------------------

def export_jsonl(trace: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta",
                            "meta": trace.get("meta", {})}) + "\n")
        for s in trace.get("spans", ()):
            f.write(json.dumps({"kind": "span", **s}) + "\n")
        for e in trace.get("events", ()):
            f.write(json.dumps({"kind": "event", **e}) + "\n")
        f.write(json.dumps({"kind": "counters",
                            "counters": trace.get("counters", {})}) + "\n")


def load_jsonl(path: str) -> Dict[str, Any]:
    """Read an ``export_jsonl`` file back into the trace-dict form
    (``{"meta", "spans", "events", "counters"}``) that exporters and
    ``obs.analyze`` consume."""
    out: Dict[str, Any] = {"meta": {}, "spans": [], "events": [],
                           "counters": {}}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.pop("kind", None)
            if kind == "meta":
                out["meta"] = rec.get("meta", {})
            elif kind == "span":
                out["spans"].append(rec)
            elif kind == "event":
                out["events"].append(rec)
            elif kind == "counters":
                out["counters"] = rec.get("counters", {})
    return out


register_exporter("chrome", export_chrome)
register_exporter("jsonl", export_jsonl)
