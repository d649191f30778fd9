"""Run ``chip_smoke.py`` with a host-clock timer around each of its functions.

    python -m dsl_tpu_torch.tools.smoke_profile [--out smoke_profile.json]

from the repo's root, on a machine with a card, as ``python3 chip_smoke.py``
runs (its output is the smoke's own). Each public module-level function
of ``chip_smoke`` but ``main`` and ``log`` is wrapped so that its calls
and their seconds add up; the totals are inclusive (a timed call made
inside another counts in both). They are written to ``--out`` as JSON, largest
first, and the largest 60 printed to stderr: where the smoke's own time
goes, phase by phase and helper by helper.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
import types
from pathlib import Path


def _timed(totals: dict, name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            n, s = totals.get(name, (0, 0.0))
            totals[name] = (n + 1, s + time.perf_counter() - t)
    return wrapper


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="smoke_profile.json",
                        help="where the totals go (JSON)")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke

    totals: dict = {}
    for name, fn in list(vars(chip_smoke).items()):
        if (isinstance(fn, types.FunctionType)
                and fn.__module__ == "chip_smoke"
                and name not in ("main", "log")
                and not name.startswith("_")):
            setattr(chip_smoke, name, _timed(totals, name, fn))
    try:
        return chip_smoke.main()
    finally:
        rows = sorted(totals.items(), key=lambda kv: -kv[1][1])
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({k: dict(calls=n, s=round(s, 2))
                                   for k, (n, s) in rows}, indent=1))
        for k, (n, s) in rows[:60]:
            print(f"[profile] {s:9.1f} s {n:5d}  {k}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
