#!/usr/bin/env python3
"""Compares the id-derived figures of two `chip_smoke.py` logs.

    python3 tools/compare_smoke_logs.py OLD.log NEW.log

Reads every phase line (a JSON object with a "phase" key) of both logs
and compares every figure of the phase lines that both logs have, but
those that vary from run to run: times and rates (keys that hold
"seconds", "_ms" or "per_second", or are "ms" or "qps", and everything
under such a key), errors against the plain versions, peak memory, and
the command line's printed lines (they hold times). So what the paths
returned and the work their kernels did is compared: ids-derived recall,
N_b, N_p, hops, kills, survivors, launch counts, graph statistics, and
any figure a later version adds. Prints one JSON line with the number of
figures compared, those that differ, and the figures found only in the
old log; exits 1 if any differ or any figure of the old log is missing
from the new (a renamed key must not drop out of the comparison
unseen).
"""

from __future__ import annotations

import json
import sys

VARYING = {"ms", "qps", "max_abs_err", "max_rel_err", "p2_err_over_norms", "peak_device_mib",
           "ptxas", "lines"}


def varying(key: str) -> bool:
    return (key in VARYING or "seconds" in key or "_ms" in key or "per_second" in key)


def wanted(path: tuple) -> bool:
    return not any(varying(str(k)) for k in path)


def leaves(obj, path=()):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from leaves(v, path + (str(k),))
    elif isinstance(obj, list):
        if all(not isinstance(v, (dict, list)) for v in obj):
            yield path, obj
        else:
            for i, v in enumerate(obj):
                yield from leaves(v, path + (str(i),))
    else:
        yield path, obj


def figures(log_path: str) -> dict:
    out, seen = {}, {}
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "phase" not in obj or obj["phase"] == "total":
                continue
            head = (obj["phase"], str(obj.get("policy", "")))
            seen[head] = seen.get(head, 0) + 1
            prefix = (*head, str(seen[head]))
            for path, value in leaves(obj):
                if path and wanted(path):
                    out[prefix + path] = value
    return out


def main(argv) -> int:
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = figures(argv[1]), figures(argv[2])
    common = sorted(set(old) & set(new))
    differ = [{"figure": "/".join(k), "old": old[k], "new": new[k]} for k in common
              if old[k] != new[k]]
    only_old = sorted("/".join(k) for k in set(old) - set(new))
    print(json.dumps({"compared": len(common), "differ": len(differ),
                      "only_old": len(only_old), "only_new": len(set(new) - set(old)),
                      "differences": differ[:50], "only_old_figures": only_old[:50]}))
    return 1 if differ or only_old else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
