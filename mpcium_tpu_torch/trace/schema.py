"""Chrome trace-event schema validation (zero-dependency).

What Perfetto/chrome://tracing actually require of the JSON object
format, written down as a checker so the committed sample trace and
every drill/soak-embedded trace can be validated in CI (`make
trace-check`) without a jsonschema dependency.
"""
from __future__ import annotations

from typing import List

_PHASES_DUR = {"X"}
_PHASES_INSTANT = {"i", "I"}
_PHASES_META = {"M"}
_KNOWN = _PHASES_DUR | _PHASES_INSTANT | _PHASES_META | {
    "B", "E", "C", "b", "e", "n", "s", "t", "f",
}


class TraceSchemaError(ValueError):
    pass


def validate_chrome(doc: object) -> int:
    """Validate a Chrome trace-event document; returns the number of
    events, raises TraceSchemaError with every problem found."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        raise TraceSchemaError(f"top level must be an object, got {type(doc).__name__}")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise TraceSchemaError("traceEvents must be a list")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN:
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing/empty name")
        if not isinstance(ev.get("pid"), (int, str)):
            errors.append(f"{where}: missing pid")
        if ph in _PHASES_META:
            if not isinstance(ev.get("args"), dict):
                errors.append(f"{where}: metadata event needs args object")
            continue
        if not isinstance(ev.get("tid"), (int, str)):
            errors.append(f"{where}: missing tid")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: ts must be a non-negative number")
        if ph in _PHASES_DUR:
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: complete event needs non-negative dur")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where}: args must be an object")
    if errors:
        raise TraceSchemaError(
            f"{len(errors)} schema violation(s): " + "; ".join(errors[:10])
        )
    return len(events)
