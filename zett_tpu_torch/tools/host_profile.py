"""Where a script's host time goes: runs the script as ``__main__`` with a
thread that reads the main thread's stack every ``--interval`` ms. Each
sample is weighted by the wall time since the one before it, so waits on
the card, on the disk and in C calls count as the time they take. Writes
the stacks and their seconds as JSON and prints the functions that took
the most time, inclusive and self.

    PYTHONHASHSEED=0 python -m zett_tpu_torch.tools.host_profile \\
        --out build/zett_tpu_torch/chip_smoke_profile.json chip_smoke.py

(``chip_smoke.py`` re-executes itself unless PYTHONHASHSEED is 0, which
would leave the sampler behind.) Sampling costs the script about 1% at
10 ms. Standard library only."""

from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time


def frame_name(code, root: str) -> str:
    """``file:function:first line``, the file relative to ``root`` where it
    lies under it."""
    path = code.co_filename
    path = os.path.relpath(path, root) if path.startswith(root + os.sep) else os.path.basename(path)
    return f"{path}:{code.co_name}:{code.co_firstlineno}"


class Sampler:
    """Sums wall time by the main thread's stack (outermost frame first)."""

    def __init__(self, interval_s: float, root: str):
        self.interval_s = interval_s
        self.root = root
        self.stacks = collections.Counter()
        self._target = threading.get_ident()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        last = time.perf_counter()
        while not self._stop.wait(self.interval_s):
            now = time.perf_counter()
            frame = sys._current_frames().get(self._target)
            stack = []
            while frame is not None:
                stack.append(frame_name(frame.f_code, self.root))
                frame = frame.f_back
            self.stacks[tuple(reversed(stack))] += now - last
            last = now

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def top(stacks, n: int):
    """(inclusive, self): the ``n`` functions with the most seconds each."""
    inclusive, own = collections.Counter(), collections.Counter()
    for stack, seconds in stacks.items():
        for name in set(stack):
            inclusive[name] += seconds
        if stack:
            own[stack[-1]] += seconds
    return inclusive.most_common(n), own.most_common(n)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True, help="the JSON file of stacks and seconds")
    p.add_argument("--interval", type=float, default=10.0, help="ms between samples")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("script")
    p.add_argument("args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    root = os.path.dirname(os.path.abspath(args.script))
    sys.argv = [args.script] + args.args
    sys.path.insert(0, root)
    code = 0
    t0 = time.perf_counter()
    with Sampler(args.interval / 1e3, root) as sampler:
        try:
            runpy.run_path(args.script, run_name="__main__")
        except SystemExit as exc:
            code = exc.code if isinstance(exc.code, int) else (exc.code is not None)
    wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"wall_s": wall, "interval_ms": args.interval,
                   "stacks": [[list(k), v] for k, v in sampler.stacks.items()]}, f)
    inclusive, own = top(sampler.stacks, args.top)
    for title, rows in (("inclusive", inclusive), ("self", own)):
        print(f"host_profile: {title} seconds of {wall:.1f} s wall", file=sys.stderr)
        for name, seconds in rows:
            print(f"  {seconds:9.2f}  {name}", file=sys.stderr)
    return code


if __name__ == "__main__":
    sys.exit(main())
