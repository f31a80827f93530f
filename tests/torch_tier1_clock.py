"""The tier-1 run's clock: when each test case started and ended, on which
worker, so that a run's wall time can be split into the time before
``tests/test_e2e.py`` starts and that file's own span.

pytest-xdist's ``--dist loadfile`` hands files out by their number of
cases, largest first; ``tests/test_e2e.py`` (13 cases, the longest file)
starts only once every file with more cases has been handed out, so the
run's wall time is about that start plus the file's span, and the span
grows with the work that runs beside it on the other workers.

Record a run (any pytest command; the folder must not exist yet)::

    TIER1_CLOCK_DIR=out python -m pytest tests/ ... -p tests.torch_tier1_clock

Each process appends one JSON line a case to ``out/<worker>.jsonl``; the
controller writes the session's start and end to ``out/main.jsonl``.
Report one or more runs::

    python -m tests.torch_tier1_clock out [out2 ...]

For each run: the session's wall time; test_e2e.py's start after the
session's, its span, its summed case time and its start over its span;
the worker time of the files handed out before it (more than 13 cases)
and the port's share of it; the worker time spent before it started, all
and the port's; the worker time of the port's files that runs beside it;
and the ten files with the most summed case time.
"""

import collections
import json
import os
import sys
import time

import pytest

E2E = "tests/test_e2e.py"
E2E_CASES = 13


def _clock_file(config):
    folder = os.environ.get("TIER1_CLOCK_DIR")
    if not folder:
        return None
    os.makedirs(folder, exist_ok=True)
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    return open(os.path.join(folder, worker + ".jsonl"), "a")


def _write(config, **record):
    out = getattr(config, "_tier1_clock", None)
    if out is not None:
        out.write(json.dumps(record) + "\n")
        out.flush()


def pytest_configure(config):
    config._tier1_clock = _clock_file(config)
    if "PYTEST_XDIST_WORKER" not in os.environ:
        _write(config, session_start=time.time())


def pytest_unconfigure(config):
    if "PYTEST_XDIST_WORKER" not in os.environ:
        _write(config, session_end=time.time())
    out = getattr(config, "_tier1_clock", None)
    if out is not None:
        out.close()
        config._tier1_clock = None


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    """A case's setup, call and teardown (under xdist only the workers run
    cases)."""
    start = time.time()
    yield
    _write(item.config, id=item.nodeid,
           worker=os.environ.get("PYTEST_XDIST_WORKER", "main"),
           start=start, end=time.time())


def load(folder: str):
    """(session start, session end, [case records]) of a recorded run."""
    start = end = None
    cases = []
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name)) as f:
            for line in f:
                rec = json.loads(line)
                start = rec.get("session_start", start)
                end = rec.get("session_end", end)
                if "id" in rec:
                    cases.append(rec)
    return start, end, cases


def _overlap(rec, lo: float, hi: float) -> float:
    return max(0.0, min(rec["end"], hi) - max(rec["start"], lo))


def report(folder: str) -> dict:
    start, end, cases = load(folder)
    by_file = collections.defaultdict(list)
    for rec in cases:
        by_file[rec["id"].split("::")[0]].append(rec)
    spent = {f: sum(r["end"] - r["start"] for r in rs)
             for f, rs in by_file.items()}
    e2e = by_file.get(E2E, [])
    e2e_lo = min((r["start"] for r in e2e), default=None)
    e2e_hi = max((r["end"] for r in e2e), default=None)
    front = [f for f, rs in by_file.items() if len(rs) > E2E_CASES]
    port = [f for f in by_file if os.path.basename(f).startswith("test_torch")]
    before = port_before = beside = 0.0
    if e2e_lo is not None:
        before = sum(_overlap(r, start, e2e_lo) for r in cases)
        port_before = sum(_overlap(r, start, e2e_lo) for f in port
                          for r in by_file[f])
        beside = sum(_overlap(r, e2e_lo, e2e_hi) for f in port
                     for r in by_file[f])
    top = sorted(spent.items(), key=lambda kv: -kv[1])[:10]
    return {
        "run": folder,
        "wall_s": None if end is None else round(end - start, 2),
        "cases": len(cases),
        "e2e_start_s": None if e2e_lo is None else round(e2e_lo - start, 2),
        "e2e_span_s": None if e2e_lo is None else round(e2e_hi - e2e_lo, 2),
        "e2e_case_s": round(spent.get(E2E, 0.0), 2),
        # the start in units of the file's own span: a box that runs
        # slower stretches both, so runs on a busy and an idle box compare
        "e2e_start_per_span": None if e2e_lo is None
        else round((e2e_lo - start) / max(e2e_hi - e2e_lo, 1e-9), 4),
        "after_e2e_s": None if e2e_hi is None or end is None
        else round(end - e2e_hi, 2),
        "front_worker_s": round(sum(spent[f] for f in front), 2),
        "front_port_worker_s": round(sum(spent[f] for f in front
                                         if f in port), 2),
        "before_e2e_worker_s": round(before, 2),
        "port_before_e2e_worker_s": round(port_before, 2),
        "port_beside_e2e_worker_s": round(beside, 2),
        "all_worker_s": round(sum(spent.values()), 2),
        "top_files": [[f, round(s, 2), len(by_file[f])] for f, s in top],
    }


def main(argv) -> None:
    for folder in argv:
        print(json.dumps(report(folder)))


if __name__ == "__main__":
    main(sys.argv[1:])
