"""Prometheus text exposition for the nested ``metrics()`` snapshot.

The snapshot is a tree of counters/gauges with a handful of *instance-keyed*
sections (per-file handles, per-tenant tables, fleet peers, cache tiers).
`render_prometheus` flattens it:

  * nested dict keys join into the metric name
    (``scheduler.done`` → ``repro_scheduler_done``);
  * instance-keyed sections become labels instead of name parts
    (``per_file["f0"]["reads"]`` →
    ``repro_file_reads{handle="f0",...}``) — the mapping lives in
    `LABEL_DIMENSIONS`;
  * *string* fields inside a dict become labels on that dict's numeric
    samples (``per_file["f0"]["codec"] == "gzip"`` attaches
    ``codec="gzip"``), which is how tenant/handle/codec ride along;
  * the ``obs.histograms`` section renders as real Prometheus histograms:
    one ``<prefix>_latency_seconds`` family, ``span`` label per series,
    cumulative ``_bucket`` rows (``le`` in seconds), ``_sum``/``_count``;
  * booleans render 0/1; None and non-finite floats are dropped; lists are
    dropped (histogram bucket vectors are the one list that matters and it
    is handled above).

Everything is typed ``gauge`` except the histogram family: the snapshot
does not distinguish counters from gauges, and an untyped/gauge series
scrapes identically — ``rate()`` still works on monotone series.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Mapping, Tuple

#: Sections whose immediate children are instances: key becomes this label.
LABEL_DIMENSIONS: Dict[str, str] = {
    "per_file": "handle",
    "per_reader": "handle",
    "tenants": "tenant",
    "per_tenant": "tenant",
    "dispatch_per_tenant": "tenant",
    "dispatched_bytes_per_tenant": "tenant",
    "tenant_quanta": "tenant",
    "deficit_per_tenant": "tenant",
    "bytes_served_per_tenant": "tenant",
    "admission": "tenant",
    "streams_in_progress": "stream",
    "jobs": "job",
    "peers": "peer",
    "tiers": "tier",
}

#: Name segments dropped when a key was converted to a label ("per_file"
#: reads better as "file_..." than "per_file_...").
_NAME_REWRITES = {"per_file": "file", "per_reader": "reader", "streams_in_progress": "stream"}

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")
_FIRST_OK = re.compile(r"^[^a-zA-Z_]")

Sample = Tuple[Dict[str, str], float]


def _metric_name(parts: List[str]) -> str:
    name = "_".join(_NAME_OK.sub("_", p) for p in parts if p)
    return _FIRST_OK.sub("_", name) if _FIRST_OK.match(name) else name


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, _escape_label(str(v))) for k, v in sorted(labels.items())
    )
    return "{%s}" % inner


def _format_value(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _walk(
    node: Any,
    parts: List[str],
    labels: Dict[str, str],
    out: Dict[str, List[Sample]],
) -> None:
    if isinstance(node, bool):
        out.setdefault(_metric_name(parts), []).append((labels, 1.0 if node else 0.0))
        return
    if isinstance(node, (int, float)):
        if isinstance(node, float) and not math.isfinite(node):
            return
        out.setdefault(_metric_name(parts), []).append((labels, node))
        return
    if not isinstance(node, Mapping):
        return  # strings were promoted to labels by the caller; lists drop
    # String fields of this dict label its (and its children's) samples.
    here = dict(labels)
    for k, v in node.items():
        if isinstance(v, str):
            lk = _NAME_OK.sub("_", str(k))
            if lk and lk not in here:
                here[lk] = v
    for k, v in node.items():
        if isinstance(v, str):
            continue
        key = str(k)
        dim = LABEL_DIMENSIONS.get(key)
        if dim is not None and isinstance(v, Mapping):
            base = parts + [_NAME_REWRITES.get(key, key.replace("per_", "", 1) if key.startswith("per_") else key)]
            for inst, sub in v.items():
                inst_labels = dict(here)
                inst_labels[dim] = str(inst)
                _walk(sub, base, inst_labels, out)
        else:
            _walk(v, parts + [key], here, out)


def _render_histograms(
    hists: Mapping[str, Mapping[str, Any]], prefix: str, lines: List[str]
) -> None:
    family = "%s_latency_seconds" % prefix
    lines.append("# HELP %s Span/boundary latency (log2 buckets)." % family)
    lines.append("# TYPE %s histogram" % family)
    for name in sorted(hists):
        snap = hists[name]
        labels = {"span": name}
        count = int(snap.get("count", 0))
        cum = 0
        for le_s, cumulative in snap.get("buckets", []):
            cum = int(cumulative)
            bl = dict(labels)
            bl["le"] = repr(float(le_s))
            lines.append(
                "%s_bucket%s %d" % (family, _render_labels(bl), cum)
            )
        bl = dict(labels)
        bl["le"] = "+Inf"
        lines.append("%s_bucket%s %d" % (family, _render_labels(bl), count))
        lines.append(
            "%s_sum%s %s"
            % (family, _render_labels(labels), _format_value(float(snap.get("sum_s", 0.0))))
        )
        lines.append("%s_count%s %d" % (family, _render_labels(labels), count))


def render_prometheus(snapshot: Mapping[str, Any], prefix: str = "repro") -> str:
    """The full nested snapshot as Prometheus exposition text (version
    0.0.4 text format; one trailing newline)."""
    snapshot = dict(snapshot)
    obs_section = snapshot.get("obs")
    hists: Mapping[str, Any] = {}
    if isinstance(obs_section, Mapping):
        obs_rest = dict(obs_section)
        maybe = obs_rest.pop("histograms", {})
        if isinstance(maybe, Mapping):
            hists = maybe
        obs_rest.pop("slow_requests", None)  # span trees are not samples
        snapshot["obs"] = obs_rest

    samples: Dict[str, List[Sample]] = {}
    _walk(snapshot, [prefix], {}, samples)

    lines: List[str] = []
    for name in sorted(samples):
        lines.append("# TYPE %s gauge" % name)
        for labels, value in samples[name]:
            lines.append("%s%s %s" % (name, _render_labels(labels), _format_value(value)))
    if hists:
        _render_histograms(hists, prefix, lines)
    return "\n".join(lines) + "\n"
