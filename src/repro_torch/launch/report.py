"""The dry-run and roofline tables from ``results/dryrun_torch/`` (the
counterpart of ``repro.launch.report``; H100 constants, fits = 80 GB)."""
from __future__ import annotations

import json

from ..configs import ARCH_IDS, SHAPES
from .dryrun import cell_path
from .rescore import rescore


def load(arch, shape, multi):
    p = cell_path(arch, shape, multi)
    if not p.exists():
        return None
    return json.loads(p.read_text())


def fmt_ms(s):
    return f"{s * 1e3:.1f}" if s is not None else "—"


def dryrun_table() -> str:
    lines = [
        "| arch | shape | mesh 16x16 GB/dev (fits) | run s | "
        "mesh 2x16x16 GB/dev (fits) | collectives (single-pod) |",
        "|---|---|---|---|---|---|",
    ]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            s = load(arch, shape, False)
            m = load(arch, shape, True)
            if s is None and m is None:
                continue
            if s and s["status"] == "skipped":
                lines.append(f"| {arch} | {shape} | skipped | — | skipped | "
                             f"{s['reason'][:60]}… |")
                continue

            def cell(d):
                if d is None:
                    return "pending"
                if d["status"] != "ok":
                    return f"ERROR: {d.get('error', '')[:40]}"
                fc = d["full_compile"]
                return (f"{fc['bytes_per_device'] / 1e9:.2f} "
                        f"({'Y' if fc['fits'] else 'over'})")
            ok = s and s["status"] == "ok"
            cs = s["full_compile"]["compile_s"] if ok else "—"
            colls = ""
            if ok:
                colls = ",".join(
                    f"{k.split('-')[-1][:6]}:{v / 1e6:.0f}MB" for k, v in
                    s["full_compile"]["collectives_in_hlo"].items())
            lines.append(f"| {arch} | {shape} | {cell(s)} | {cs} | {cell(m)} "
                         f"| {colls} |")
    return "\n".join(lines)


def roofline_table() -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL/counted flops | roofline frac | lever |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    levers = {
        "compute": "shard the replicated attention/seq dims (SP) or skip "
                   "masked flash blocks",
        "memory": "larger per-card batch / fused collective-matmul / "
                  "quantised cache",
        "collective": "overlap the reduce with matmul tiles; reduce-scatter "
                      "gradients instead of all-reduce",
    }
    for arch in ARCH_IDS:
        for shape in SHAPES:
            d = load(arch, shape, False)
            if d is None:
                continue
            if d["status"] == "skipped":
                lines.append(f"| {arch} | {shape} | — | — | — | skipped | — "
                             f"| — | sub-quadratic attn required |")
                continue
            r = rescore(d)
            if r is None:
                lines.append(f"| {arch} | {shape} | — | — | — | "
                             f"{d['status']} | — | — | — |")
                continue
            lines.append(
                f"| {arch} | {shape} | {fmt_ms(r['compute_s'])}ms | "
                f"{fmt_ms(r['memory_s'])}ms | {fmt_ms(r['collective_s'])}ms | "
                f"{r['dominant']} | {r['useful_ratio']:.3f} | "
                f"{r['roofline_fraction']:.3f} ({r['ideal_basis']}) "
                f"| {levers[r['dominant']]} |")
    return "\n".join(lines)


def main():
    print("## Dry-run (H100: 80 GB a card)\n")
    print(dryrun_table())
    print("\n## Roofline (single-pod 16x16, per-card terms)\n")
    print(roofline_table())


if __name__ == "__main__":
    main()
