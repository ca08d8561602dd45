#!/usr/bin/env python
"""Where chip_smoke.py's host time goes, phase by phase.

Runs ``chip_smoke.main()`` in this process with a thread that samples the
main thread's Python stack every 10 ms.  Each sample is charged to the
phase that is running (the span that ends at the next ``phase`` line) and
to every function on the stack (inclusive time), and to the innermost
``chip_smoke.py`` line.  Writes, per phase, the sampled seconds, the
functions with the most samples and the chip_smoke.py lines with the most,
to ``--out`` (default ``build/chip_smoke_stacks.txt``).

    python tools/chip_smoke_stacks.py [--out FILE] [-- chip_smoke args]

A sample is taken only when the sampler thread holds the GIL, so time in
C calls that keep the GIL (most single PyTorch ops) is undercounted:
compare a phase's sampled seconds with its ``phase`` line's wall seconds.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "build" / "chip_smoke_stacks.txt"


def short(path: str) -> str:
    """chip_smoke.py as ``CS``; the package's files from ``repro_torch/``;
    installed packages from ``site-packages/``; else the file's name."""
    if path.endswith("chip_smoke.py"):
        return "CS"
    for marker in ("repro_torch/", "site-packages/"):
        i = path.find(marker)
        if i >= 0:
            return path[i + len(marker):]
    return os.path.basename(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--top", type=int, default=45)
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="arguments for chip_smoke.py, after --")
    args = ap.parse_args(argv)
    rest = [a for a in args.rest if a != "--"]
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    names: list[str] = []
    phase = [0]
    inclusive = collections.Counter()
    lines = collections.Counter()
    total = collections.Counter()
    mark = chip_smoke.mark

    def counted_mark(what):
        names.append(what)
        phase[0] += 1
        mark(what)

    chip_smoke.mark = counted_mark
    main_id = threading.main_thread().ident
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            time.sleep(0.01)
            frame = sys._current_frames().get(main_id)
            p = phase[0]
            total[p] += 1
            seen, innermost = set(), None
            while frame is not None:
                code = frame.f_code
                where = short(code.co_filename)
                key = f"{where}:{code.co_name}"
                if key not in seen:
                    seen.add(key)
                    inclusive[(p, key)] += 1
                if where == "CS" and innermost is None:
                    innermost = f"CS line {frame.f_lineno} ({code.co_name})"
                frame = frame.f_back
            if innermost:
                lines[(p, innermost)] += 1

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    sys.argv = [str(ROOT / "chip_smoke.py"), *rest]
    try:
        rc = chip_smoke.main()
    finally:
        stop.set()
        sampler.join()
        out = []
        for p in range(len(names) + 1):
            name = names[p] if p < len(names) else "(after the last phase)"
            out.append(f"=== phase {name}: {total[p] / 100:.1f} s sampled")
            for counter, label in ((inclusive, None),
                                   (lines, "innermost chip_smoke.py lines")):
                if label:
                    out.append(f"  -- {label}:")
                top = sorted(((c, k) for (q, k), c in counter.items()
                              if q == p), reverse=True)[:args.top]
                out += [f"  {c / 100:8.2f} s  {k}" for c, k in top]
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(out) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
