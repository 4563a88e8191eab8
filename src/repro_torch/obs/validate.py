"""Chrome-trace JSON validator, the schema gate for exported traces (copy of
``repro.obs.validate``).

Checks that a trace exported by ``repro_torch.obs.trace`` (``export`` /
``chrome_trace``, or any Chrome ``trace_event`` document of complete
events) is well-formed:

  * the document is ``{"traceEvents": [...]}``; every event has a string
    ``name``, ``ph == "X"``, numeric non-negative ``ts``/``dur``, and
    integer ``pid``/``tid``; ``args``, when present, is an object;
  * spans on one thread properly NEST: sorted by start time, every pair
    of spans is either disjoint or one contains the other (a small float
    epsilon absorbs the ns->us conversion);
  * optionally (``--require-span`` / ``--min-coverage``): spans with a
    given name exist, and the fraction of their wall-clock covered by
    their direct child spans meets a floor: every batch is attributed to
    named phases, checked on the CLIs' own traces (``kcore_run --trace``,
    ``kcore_serve --trace``), not just unit-test traces.

Usage::

    python -m repro_torch.obs.validate trace.json [more.json ...] \
        [--require-span NAME] [--min-coverage 0.95]
"""

from __future__ import annotations

import argparse
import json
import sys

_EPS_US = 0.01  # ns->us float conversion slack


class TraceValidationError(ValueError):
    pass


def _check_event(i: int, ev) -> None:
    if not isinstance(ev, dict):
        raise TraceValidationError(f"event {i}: not an object")
    if not isinstance(ev.get("name"), str) or not ev["name"]:
        raise TraceValidationError(f"event {i}: missing/empty name")
    if ev.get("ph") != "X":
        raise TraceValidationError(
            f"event {i} ({ev['name']}): ph must be 'X', got {ev.get('ph')!r}")
    for field in ("ts", "dur"):
        v = ev.get(field)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise TraceValidationError(
                f"event {i} ({ev['name']}): {field} must be numeric")
        if v < 0:
            raise TraceValidationError(
                f"event {i} ({ev['name']}): negative {field} ({v})")
    for field in ("pid", "tid"):
        if not isinstance(ev.get(field), int):
            raise TraceValidationError(
                f"event {i} ({ev['name']}): {field} must be an int")
    if "args" in ev and not isinstance(ev["args"], dict):
        raise TraceValidationError(
            f"event {i} ({ev['name']}): args must be an object")


def _nesting_sweep(spans: list[dict]) -> dict[int, list[int]]:
    """Stack sweep of one thread's spans (sorted by start, longest first).

    Raises on partial overlap; returns ``{span_index: [child indices]}``
    with DIRECT children only (indices into the given list).
    """
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i]["ts"], -spans[i]["dur"]))
    children: dict[int, list[int]] = {i: [] for i in order}
    stack: list[int] = []  # indices of currently open spans
    for i in order:
        s, e = spans[i]["ts"], spans[i]["ts"] + spans[i]["dur"]
        while stack:
            top = spans[stack[-1]]
            top_end = top["ts"] + top["dur"]
            if s >= top_end - _EPS_US:
                stack.pop()          # previous span closed before we start
                continue
            if e > top_end + _EPS_US:
                raise TraceValidationError(
                    f"spans overlap without nesting: {spans[i]['name']!r} "
                    f"[{s:.3f}, {e:.3f}]us vs {top['name']!r} "
                    f"[{top['ts']:.3f}, {top_end:.3f}]us on tid "
                    f"{spans[i]['tid']}")
            break
        if stack:
            children[stack[-1]].append(i)
        stack.append(i)
    return children


def span_tree_coverage(events: list[dict], name: str) -> list[dict]:
    """Per-instance coverage of ``name`` spans by their direct children.

    Returns one ``{"dur_us", "child_us", "coverage", "children"}`` record
    per span named ``name``. Child intervals cannot overlap (nesting is
    validated first), so summing child durations is exact coverage.
    """
    out = []
    by_tid: dict[tuple, list[dict]] = {}
    for ev in events:
        by_tid.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for spans in by_tid.values():
        children = _nesting_sweep(spans)
        for i, kids in children.items():
            if spans[i]["name"] != name:
                continue
            dur = spans[i]["dur"]
            child_us = sum(spans[j]["dur"] for j in kids)
            out.append({
                "dur_us": dur,
                "child_us": child_us,
                "coverage": child_us / dur if dur > 0 else 1.0,
                "children": sorted({spans[j]["name"] for j in kids}),
            })
    return out


def validate_chrome_trace(doc) -> dict:
    """Validate one trace document; returns a summary dict or raises
    ``TraceValidationError``."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise TraceValidationError("document must be {'traceEvents': [...]}")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise TraceValidationError("traceEvents must be a list")
    for i, ev in enumerate(events):
        _check_event(i, ev)
    by_tid: dict[tuple, list[dict]] = {}
    for ev in events:
        by_tid.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    max_depth = 0
    for spans in by_tid.values():
        children = _nesting_sweep(spans)
        # depth via the child map (roots = spans that are nobody's child)
        child_ids = {j for kids in children.values() for j in kids}
        depth: dict[int, int] = {}

        def _depth(i: int) -> int:
            if i not in depth:
                depth[i] = 1 + max((_depth(j) for j in children[i]),
                                   default=0)
            return depth[i]

        for i in children:
            if i not in child_ids:
                max_depth = max(max_depth, _depth(i))
    names: dict[str, int] = {}
    for ev in events:
        names[ev["name"]] = names.get(ev["name"], 0) + 1
    return {"events": len(events), "threads": len(by_tid),
            "max_depth": max_depth, "names": names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate Chrome trace_event JSON files")
    ap.add_argument("paths", nargs="+", help="trace JSON files to validate")
    ap.add_argument("--require-span", default=None, metavar="NAME",
                    help="fail unless >=1 span with this name exists")
    ap.add_argument("--min-coverage", type=float, default=None,
                    help="minimum fraction of each --require-span span's "
                         "wall covered by its direct child spans")
    args = ap.parse_args(argv)
    if args.min_coverage is not None and args.require_span is None:
        ap.error("--min-coverage requires --require-span")

    rc = 0
    for path in args.paths:
        try:
            with open(path) as f:
                doc = json.load(f)
            summary = validate_chrome_trace(doc)
            msg = (f"{path}: OK — {summary['events']} events, "
                   f"{summary['threads']} thread(s), "
                   f"max depth {summary['max_depth']}")
            if args.require_span is not None:
                cov = span_tree_coverage(doc["traceEvents"],
                                         args.require_span)
                if not cov:
                    raise TraceValidationError(
                        f"no span named {args.require_span!r}")
                worst = min(c["coverage"] for c in cov)
                msg += (f"; {len(cov)} {args.require_span!r} span(s), "
                        f"min child coverage {worst:.3f}")
                if args.min_coverage is not None and worst < args.min_coverage:
                    raise TraceValidationError(
                        f"{args.require_span!r} child coverage {worst:.3f} "
                        f"< required {args.min_coverage}")
            print(msg)
        except (OSError, json.JSONDecodeError, TraceValidationError) as e:
            print(f"{path}: INVALID — {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
