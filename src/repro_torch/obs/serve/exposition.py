"""Prometheus text exposition (format version 0.0.4) rendered from a
``Registry.snapshot()`` dict.

The port of the JAX package's ``repro.obs.serve.exposition``
(``src/repro/obs/serve/exposition.py``), the same code: one snapshot
dict renders to the same text in both packages.

The registry's naming scheme maps onto Prometheus' naming rules
mechanically:

* dotted paths become underscore paths (``stream.appends`` ->
  ``stream_appends``);
* a per-stream instance label ``name[caldot1/train0]`` becomes a
  ``{stream="caldot1/train0"}`` label pair on the shared family name;
* histogram summaries render as Prometheus summaries — one
  ``{quantile="…"}`` sample per interpolated quantile plus ``_sum``
  and ``_count`` — min/max stay JSON-only (``/snapshot``);
* provider metrics whose value is a dict (DriftMonitor summaries) are
  not representable as flat samples and are skipped here.

Values are ints (counters) or floats (gauges): the renderer decides
sample shape from the VALUE, so it needs no side channel about metric
kinds and works on any snapshot dict.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

__all__ = ["render_prometheus", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_INSTANCE = re.compile(r"^(?P<base>[^\[\]]+)\[(?P<inst>[^\[\]]*)\]$")
_QUANTILES = ("p50", "p95", "p99")


def _split_instance(name: str) -> Tuple[str, str]:
    m = _INSTANCE.match(name)
    if m:
        return m.group("base"), m.group("inst")
    return name, ""


def _prom_name(base: str) -> str:
    out = _NAME_SANITIZE.sub("_", base)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def render_prometheus(snapshot: Dict[str, object]) -> str:
    """The snapshot as exposition text (one trailing newline; empty
    snapshot -> empty string)."""
    families: Dict[str, List[str]] = {}
    types: Dict[str, str] = {}
    for name in sorted(snapshot):
        value = snapshot[name]
        base, inst = _split_instance(name)
        fam = _prom_name(base)
        labels = ""
        if inst:
            labels = '{stream="%s"}' % _escape_label(inst)
        if isinstance(value, bool) or isinstance(value, (int, float)):
            kind = "counter" if isinstance(value, int) \
                and not isinstance(value, bool) else "gauge"
            types.setdefault(fam, kind)
            families.setdefault(fam, []).append(
                f"{fam}{labels} {_fmt(value)}")
        elif isinstance(value, dict) and "count" in value:
            types.setdefault(fam, "summary")
            lines = families.setdefault(fam, [])
            count = value.get("count", 0)
            mean = value.get("mean", 0.0)
            for key in _QUANTILES:
                if key in value:
                    q = "0." + key[1:]
                    sep = "," if labels else ""
                    inner = labels[1:-1] + sep if labels else ""
                    lines.append(
                        f'{fam}{{{inner}quantile="{q}"}} '
                        f"{_fmt(float(value[key]))}")
            lines.append(f"{fam}_sum{labels} "
                         f"{_fmt(float(mean) * count)}")
            lines.append(f"{fam}_count{labels} {int(count)}")
        # anything else (drift provider dicts, None) is JSON-only
    out: List[str] = []
    for fam in sorted(families):
        out.append(f"# TYPE {fam} {types[fam]}")
        out.extend(families[fam])
    return "\n".join(out) + ("\n" if out else "")
