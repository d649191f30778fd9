"""Build every model config of the repo on the meta device and count what
the port refuses.

    python -m dsl_tpu_torch.tools.config_sweep [configs]

Each config under the directory (``_base_`` aside) that has a ``model`` is
built by ``build_detector`` on the meta device (no weights are made); a
config that raises is counted under its exception's first line (the first
refusal). Prints the totals, then the refusals by count, each with up to
two configs.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os.path as osp

import torch


def sweep(root: str = "configs"):
    """(configs, built, {first refusal: [config paths]})."""
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models import build_detector

    total, built = 0, 0
    refused: dict = collections.defaultdict(list)
    for path in sorted(glob.glob(osp.join(root, "**", "*.py"), recursive=True)):
        if f"{osp.sep}_base_{osp.sep}" in path:
            continue
        model = Config.fromfile(path).get("model")
        if model is None:
            continue
        total += 1
        try:
            with torch.device("meta"):
                build_detector(dict(model))
            built += 1
        except Exception as e:     # the refusal is what is counted
            line = str(e).splitlines()[0] if str(e) else ""
            refused[f"{type(e).__name__}: {line[:100]}"].append(path)
    return total, built, dict(refused)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root", nargs="?", default="configs")
    args = parser.parse_args(argv)
    total, built, refused = sweep(args.root)
    print(f"{built} of {total} build, {total - built} are refused")
    for what, paths in sorted(refused.items(), key=lambda kv: -len(kv[1])):
        print(f"{len(paths):4d}  {what}  {paths[:2]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
