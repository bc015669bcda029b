"""Recompute the roofline rows from stored dry-run JSONs, with the H100's
constants (no rerun needed when the scoring rules change).

The counterpart of ``repro.launch.rescore``, over
``results/dryrun_torch/``. Fractions:
  train/prefill: ideal = MODEL_FLOPS / (chips x peak)   (compute)
  decode:        ideal = argument_bytes / HBM bandwidth (weights and cache
                 read once a token)
  fraction = ideal / max(compute_s, memory_s, collective_s, ideal)
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from ..configs import SHAPES, get_config
from .dryrun import RESULTS
from .roofline import HBM_BW, PEAK_FLOPS, collective_seconds, model_flops


def rescore(d: dict) -> Optional[Dict]:
    if d.get("status") != "ok" or "costs" not in d:
        return None
    cfg = get_config(d["arch"])
    shape = SHAPES[d["shape"]]
    n_chips = 256 if d["mesh"] == "16x16" else 512
    c = d["costs"]
    fc = d["full_compile"]
    compute_s = c["flops_per_dev"] / PEAK_FLOPS
    memory_s = c["traffic_bytes_per_dev"] / HBM_BW
    coll_s = collective_seconds(sum(c["collective_bytes_per_dev"].values()),
                                c.get("network_bytes_per_dev", 0.0))
    bound = max(compute_s, memory_s, coll_s)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape) / n_chips
    if shape.kind == "decode":
        ideal = fc["argument_bytes"] / HBM_BW
        basis = "bandwidth(args)"
    else:
        ideal = mf / PEAK_FLOPS
        basis = "compute(6ND)"
    frac = min(1.0, ideal / max(bound, ideal, 1e-12))
    return dict(compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
                dominant=dominant, ideal_s=ideal, ideal_basis=basis,
                useful_ratio=mf / max(1.0, c["flops_per_dev"]),
                roofline_fraction=frac)


def all_rows():
    rows = {}
    for f in sorted(RESULTS.glob("*.json")):
        if len(f.stem.split("__")) != 3:
            continue                      # tagged variants
        d = json.loads(f.read_text())
        r = rescore(d)
        if r is not None:
            rows[(d["arch"], d["shape"], d["mesh"])] = r
    return rows


def main():
    for k, r in sorted(all_rows().items(),
                       key=lambda kv: kv[1]["roofline_fraction"]):
        print(f"{k[0]:27s} {k[1]:12s} {k[2]:8s} {r['dominant']:10s} "
              f"frac={r['roofline_fraction']:.3f} "
              f"ideal={r['ideal_s'] * 1e3:.1f}ms [{r['ideal_basis']}]")


if __name__ == "__main__":
    main()
