"""Markdown tables of a dry-run sweep: one row per cell of the JSON files
that `python -m repro_torch.launch.dryrun --out DIR` wrote, and for each
decode cell the per-device bytes of its caches under their specs (batch
over dp, cache_seq and inner over 'model': where the port places them,
`launch.specs.decode_specs`, and the reference's spec alike).

  PYTHONPATH=src python tools/dryrun_table.py DIR [--mesh 16x16]

HBM_BYTES is one H100's 80 GB: a cell fits when its peak (arguments +
temp) is at most that.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

HBM_BYTES = 80e9
KINDS = (("all-gather", "AG"), ("all-reduce", "AR"), ("reduce-scatter", "RS"),
         ("all-to-all", "A2A"), ("collective-permute", "CP"))


def cache_bytes(arch: str, shape_name: str, multi_pod: bool) -> int:
    """The cell's cache bytes per device under their specs."""
    from repro_torch.configs.base import SHAPES, get_arch
    from repro_torch.dist.sharding import Runtime, logical_to_spec, mesh_shape, spec_axes
    from repro_torch.launch.dryrun import optimized_settings
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import cache_specs
    from repro_torch.models.params import _map_specs
    from repro_torch.tree import leaves

    cfg, shape = get_arch(arch), SHAPES[shape_name]
    rt = Runtime(mesh=make_production_mesh(multi_pod=multi_pod),
                 **{k: v for k, v in optimized_settings(arch, shape_name).items()
                    if k in ("moe_decode_gather", "full_dp")})
    sizes = mesh_shape(rt.mesh)

    def local(spec) -> int:
        p = logical_to_spec(spec.logical, spec.shape, rt)
        n = math.prod(d // math.prod(sizes[a] for a in spec_axes(e))
                      for d, e in zip(spec.shape, p))
        return n * spec.dtype.itemsize

    return sum(local(s) for s in leaves(_map_specs(lambda s: s, cache_specs(
        cfg, shape.global_batch, shape.seq_len))))


def fallbacks(arch: str, multi_pod: bool) -> list:
    """The dims the decode cell's specs leave whole (`dryrun.spec_fallbacks`)."""
    from repro_torch.configs.base import SHAPES, get_arch
    from repro_torch.dist.sharding import Runtime
    from repro_torch.launch.dryrun import spec_fallbacks
    from repro_torch.launch.mesh import make_production_mesh

    rt = Runtime(mesh=make_production_mesh(multi_pod=multi_pod))
    return [tuple(f) for f in spec_fallbacks(get_arch(arch), SHAPES["decode_32k"], rt)]


def _settings(c: dict) -> str:
    from repro_torch.launch.dryrun import optimized_settings

    s = optimized_settings(c["arch"], c["shape"])
    out = [f"mb {s['microbatches']}" if "microbatches" in s else ""]
    out += [k.replace("_", "-") for k in ("full_dp", "moe_decode_gather") if s.get(k)]
    return ", ".join(x for x in out if x) or "—"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    cells = [json.loads(p.read_text()) for p in sorted(Path(args.dir).glob("*.json"))]
    cells = [c for c in cells if c.get("mesh") == args.mesh]
    ok = [c for c in cells if c["status"] == "ok"]
    gib, mib = 2**30, 2**20

    def fb(arch):
        return fallbacks(arch, args.mesh != "16x16")

    print("| cell | settings | args / temp GiB | fits 80 GB | flops | "
          + " / ".join(short for _, short in KINDS[:4]) + " MiB | roofline c / m / x s | "
          "trace s | caches GiB |")
    print("|" + " --- |" * 9)
    for c in ok:
        pd, rf = c["per_device"], c["roofline_seconds"]
        peak = pd["argument_bytes"] + pd["temp_bytes"]
        coll = [c["collectives"].get(kind, {}).get("bytes", 0.0) / mib for kind, _ in KINDS]
        assert coll[4] == 0.0, c["collectives"]          # no collective-permute on this path
        caches = "—"
        if c["shape"] in ("decode_32k", "long_500k"):
            caches = f"{cache_bytes(c['arch'], c['shape'], args.mesh != '16x16') / gib:.2f}"
        print(f"| {c['arch']} x {c['shape']} | {_settings(c)} | "
              f"{pd['argument_bytes'] / gib:.2f} / {pd['temp_bytes'] / gib:.2f} | "
              f"{'yes' if peak <= HBM_BYTES else 'no'} | {pd['flops']:.3g} | "
              + " / ".join(f"{x:.0f}" for x in coll[:4])
              + f" | {rf['compute']:.3g} / {rf['memory']:.3g} / {rf['collective']:.3g} | "
              f"{c['trace_s']} | {caches} |")
    print("\nfallbacks (logical axis, dim, axis size) of the decode cells' specs: "
          + "; ".join(f"{a}: {fb(a)}" for a in sorted({c['arch'] for c in ok}) if fb(a)))
    bad = [c for c in cells if c["status"] == "error"]
    skipped = [c for c in cells if c["status"] == "skipped"]
    print(f"\n{len(ok)} ok, {len(skipped)} skipped, {len(bad)} errors; "
          f"trace seconds summed: {sum(c['trace_s'] for c in ok):.0f}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
