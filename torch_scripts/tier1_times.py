#!/usr/bin/env python3
"""Where the tier-1 command's time goes, from its junit file.

    python3 torch_scripts/tier1_times.py RUN.xml [--top 10]

Reads the junit XML that the tier-1 command writes (``--junitxml``) and
prints the test-seconds of the whole suite and of the port's files
(``tests/test_torch_*.py``), the costliest files, and a simulation of how
``pytest-xdist --dist loadfile -n 6`` hands the files out: files queued by
test count, most first, ties in name order, each to the first worker that
falls idle.  It prints the simulated wall (after a start-up of ``--startup``
seconds a worker) and when ``tests/test_train_multichip.py`` starts, and the
lower bound of any arrangement, the test-seconds over the workers.
``--split-port K`` simulates the port's files of more than K tests split
into files of at most K (their times shared evenly).

The junit times are the times inside that run: they hold the run's
contention, so a simulation of another arrangement reads them as if it
did not change.  Runs on the host alone.
"""
from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def file_times(path):
    """file -> (tests, seconds) from a junit XML."""
    out = collections.defaultdict(lambda: [0, 0.0])
    for case in ET.parse(path).getroot().iter("testcase"):
        name = case.get("classname").replace(".", "/") + ".py"
        out[name][0] += 1
        out[name][1] += float(case.get("time", 0.0))
    return {k: tuple(v) for k, v in out.items()}


def split_port(times, k):
    """The port's files of more than k tests as files of at most k."""
    out = {}
    for name, (n, seconds) in times.items():
        if "/test_torch_" not in name or n <= k:
            out[name] = (n, seconds)
            continue
        parts = -(-n // k)
        for j in range(parts):
            out[f"{name[:-3]}_{j}.py"] = (n // parts + (j < n % parts),
                                          seconds / parts)
    return out


def simulate(times, workers=6, startup=20.0):
    """(wall, start of each file) of xdist's loadfile order."""
    queue = sorted(times.items(), key=lambda kv: (-kv[1][0], kv[0]))
    free = [(startup, i) for i in range(workers)]
    heapq.heapify(free)
    start = {}
    for name, (_, seconds) in queue:
        at, i = heapq.heappop(free)
        start[name] = at
        heapq.heappush(free, (at + seconds, i))
    return max(at for at, _ in free), start


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("junit")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--startup", type=float, default=20.0)
    ap.add_argument("--split-port", type=int, default=0)
    args = ap.parse_args()
    times = file_times(args.junit)
    total = sum(s for _, s in times.values())
    port = sum(s for f, (_, s) in times.items() if "/test_torch_" in f)
    print(f"test-seconds {total:.0f}, of them the port's files {port:.0f}")
    costly = sorted(times.items(), key=lambda kv: -kv[1][1])
    for name, (n, s) in costly[:args.top]:
        print(f"  {s:8.1f} s  {n:3d} tests  {name}")
    print("  the port's costliest:")
    for name, (n, s) in [kv for kv in costly
                         if "/test_torch_" in kv[0]][:args.top]:
        print(f"  {s:8.1f} s  {n:3d} tests  {name}")
    if args.split_port:
        times = split_port(times, args.split_port)
    wall, start = simulate(times, args.workers, args.startup)
    multichip = start.get("tests/test_train_multichip.py")
    print(f"simulated loadfile wall {wall:.0f} s"
          + (f", test_train_multichip.py starts at {multichip:.0f} s"
             if multichip is not None else "")
          + f"; lower bound {total / args.workers + args.startup:.0f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
