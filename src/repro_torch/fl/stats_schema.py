"""Schema pins for ``FLResult.driver_stats`` and the engine benchmark's report.

Consumers (``chip_smoke.py``, the tests, a benchmark report) read these
dicts by key, and a renamed or dropped key shows only as a ``KeyError`` long
after the change that caused it.  The contract lives here:

* :data:`DRIVER_STATS_SCHEMA` — the keys and types of each leg: the base
  ``scan`` keys every compiled job reports, and the ``async`` leg a job with
  ``async_rounds=`` adds;
* :func:`validate_driver_stats` — checks a ``driver_stats`` dict (the loop
  driver reports ``{}``, which is valid);
* :func:`validate_bench_report` — checks an engine benchmark report's
  structure before it is written.

The base leg pins the port's keys as ``fl/scan_driver.py`` reports them.
The port replays captured CUDA graphs where the reference compiles XLA
programs, so ``captures_chunk`` / ``captures_total`` (graph captures made
while dispatching chunks / in all) take the place of the reference's
``compiles_chunk`` / ``compiles_total``; the rest of the reference's base
keys keep their names, and the port adds its own counters (programs, host
syncs, replays, launches by kernel, steps, bytes).  The async leg is the
reference's three keys.
"""
from __future__ import annotations

import numbers
from typing import Any, Dict, Mapping, Tuple

# key -> accepted types; an entry that means "a number, not a flag" rejects
# bool (an int subclass) in _check_type
_NUM = (numbers.Real,)
_INT = (numbers.Integral,)

DRIVER_STATS_SCHEMA: Dict[str, Dict[str, Tuple[type, ...]]] = {
    # every compiled scan job
    "scan": {
        "driver": (str,),
        "pipeline": (bool,),
        "store": (str,),
        "chunks": _INT,
        "speculative_chunks": _INT,
        "cancelled_chunks": _INT,
        "host_build_s": _NUM,
        "device_wait_s": _NUM,
        "host_flush_s": _NUM,
        "total_s": _NUM,
        "schedule_bytes_host": _INT,
        "page_bytes_h2d": _INT,
        "peak_live_bytes": _INT,
        "captures_chunk": _INT,
        "captures_total": _INT,
        "capture_s": _NUM,
        "programs": _INT,
        "host_syncs": _INT,
        "replays": _INT,
        "replay_launches": (dict,),
        "warmup_launches": (dict,),
        "steps": (list,),
        "h2d_bytes": _INT,
        "store_bytes_device": _INT,
        "store_bytes_host": _INT,
    },
    # jobs with async_rounds=AsyncConfig(...)
    "async": {
        "async_max_staleness": _INT,
        "async_arrivals": _INT,
        "async_pending_at_exit": _INT,
    },
}

# keys a consumer may attach after the run (a benchmark's own compile count)
OPTIONAL_EXTRAS = frozenset({"bench_compiles"})


def _check_type(key: str, value: Any, types: Tuple[type, ...]) -> None:
    if bool not in types and isinstance(value, bool):
        raise ValueError(f"driver_stats[{key!r}] must be numeric, got bool")
    if not isinstance(value, types):
        raise ValueError(f"driver_stats[{key!r}] must be {'/'.join(t.__name__ for t in types)}, "
                         f"got {type(value).__name__} ({value!r})")


def validate_driver_stats(stats: Mapping[str, Any]) -> None:
    """Validate a ``driver_stats`` dict against the schema.

    ``{}`` (the loop driver) is valid.  Otherwise every base key must be
    there with its type; any ``async_*`` key needs the whole async leg; an
    unknown key is refused (a typo, or a new stat that belongs in the
    schema).  ``driver`` must be ``"scan"``, ``store`` ``"resident"`` or
    ``"paged"``, and the launch counts ints by kernel name.
    """
    if not stats:
        return
    base, asyn = DRIVER_STATS_SCHEMA["scan"], DRIVER_STATS_SCHEMA["async"]
    for key, types in base.items():
        if key not in stats:
            raise ValueError(f"driver_stats missing required key {key!r}")
        _check_type(key, stats[key], types)
    has_async = any(k in stats for k in asyn)
    if has_async:
        for key, types in asyn.items():
            if key not in stats:
                raise ValueError(f"driver_stats has async keys but is missing {key!r}")
            _check_type(key, stats[key], types)
    known = set(base) | (set(asyn) if has_async else set()) | OPTIONAL_EXTRAS
    unknown = set(stats) - known
    if unknown:
        raise ValueError(f"driver_stats has unknown keys {sorted(unknown)}; add them to "
                         "repro_torch.fl.stats_schema.DRIVER_STATS_SCHEMA or fix the typo")
    if stats["driver"] != "scan":
        raise ValueError(f"driver_stats['driver'] must be 'scan', got {stats['driver']!r}")
    if stats["store"] not in ("resident", "paged"):
        raise ValueError(
            f"driver_stats['store'] must be 'resident' or 'paged', got {stats['store']!r}")
    for key in ("replay_launches", "warmup_launches"):
        for name, count in stats[key].items():
            if not isinstance(name, str) or not isinstance(count, numbers.Integral) \
                    or isinstance(count, bool):
                raise ValueError(f"driver_stats[{key!r}] must map kernel names to ints, "
                                 f"got {name!r}: {count!r}")


_REPORT_REQUIRED = {
    "benchmark": (str,),
    "devices": _INT,
    "backend": (str,),
    "mode": (str,),
    "engines": (dict,),
}


def validate_bench_report(report: Mapping[str, Any]) -> None:
    """Validate an engine benchmark report before it is written: the
    identity keys, and per engine leg a positive ``s_per_round``, a numeric
    ``rounds_per_s`` or None, and an optional ``compiles`` dict of ints with
    ``total``."""
    for key, types in _REPORT_REQUIRED.items():
        if key not in report:
            raise ValueError(f"bench report missing required key {key!r}")
        _check_type(key, report[key], types)
    if not report["engines"]:
        raise ValueError("bench report has no engine legs")
    for leg, entry in report["engines"].items():
        if not isinstance(entry, Mapping):
            raise ValueError(f"engine leg {leg!r} must be a dict")
        if "s_per_round" not in entry:
            raise ValueError(f"engine leg {leg!r} missing s_per_round")
        spr = entry["s_per_round"]
        if not isinstance(spr, numbers.Real) or isinstance(spr, bool) or spr <= 0:
            raise ValueError(
                f"engine leg {leg!r} s_per_round must be a positive number, got {spr!r}")
        rps = entry.get("rounds_per_s")
        if rps is not None and (not isinstance(rps, numbers.Real) or isinstance(rps, bool)):
            raise ValueError(f"engine leg {leg!r} rounds_per_s must be numeric or None")
        compiles = entry.get("compiles")
        if compiles is not None:
            if not isinstance(compiles, Mapping) or "total" not in compiles:
                raise ValueError(f"engine leg {leg!r} compiles must be a dict with 'total'")
            for ck, cv in compiles.items():
                if cv is not None and (not isinstance(cv, numbers.Integral)
                                       or isinstance(cv, bool)):
                    raise ValueError(f"engine leg {leg!r} compiles[{ck!r}] must be an int")
