"""Render the port's dry-run and hillclimb JSON into markdown tables (the
port's twin of ``experiments/render_tables.py``).

    python experiments/render_tables_torch.py roofline experiments/dryrun_torch.json
    python experiments/render_tables_torch.py perf experiments/perf_iterations_torch.json

The roofline table reads ``fits_80gb`` (an H100's memory, where the
reference reads a 16 GB TPU chip's ``fits_16gb``) and adds the seconds
each cell's dry run took and its collectives by kind (the backward's in
brackets); ``fail`` and ``skip`` rows keep the reference's wording.
"""
import json
import sys


def _kinds(counts: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in sorted(counts.items())) or "none"


def roofline_table(path):
    rows = json.load(open(path))
    out = ["| cell | peak GB/chip | fits | t_comp ms | t_mem ms "
           "| t_mem floor | t_coll ms | bottleneck | useful FLOPs "
           "| MFU bound | run s | collectives (backward) |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") == "skip":
            out.append(f"| {r['cell']} | — | — | — | — | — | — "
                       "| skip: sub-quadratic only | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            out.append(f"| {r['cell']} | FAIL | | | | | "
                       f"| {r.get('error', '')[:40]} | | | | |")
            continue
        coll = _kinds(r["collectives"])
        if r.get("collectives_in_backward"):
            coll += f" ({_kinds(r['collectives_in_backward'])})"
        out.append(
            f"| {r['cell']} | {r['peak_mem_gb_per_chip']:.1f} | "
            f"{'yes' if r['fits_80gb'] else 'NO'} | {r['t_compute_ms']:.1f} | "
            f"{r['t_memory_ms']:.0f} | {r['t_memory_floor_ms']:.1f} | "
            f"{r['t_collective_ms']:.0f} | {r['bottleneck']} | "
            f"{r['useful_flops_frac']:.2f} | {r['mfu_bound']:.2%} | "
            f"{r['t_run_s']:.1f} | {coll} |")
    return "\n".join(out)


def perf_table(path):
    chains = json.load(open(path))
    out = []
    for c in chains:
        out.append(f"\n**Cell: {c['cell']}**\n")
        out.append("| variant | hypothesis (abridged) | mem ms | coll ms "
                   "| compute ms | peak GB | run s | verdict |")
        out.append("|---|---|---|---|---|---|---|---|")
        prev = None
        for r in c["rows"]:
            verdict = ""
            if prev is not None:
                dm = ((r["t_memory_ms"] - prev["t_memory_ms"])
                      / max(prev["t_memory_ms"], 1))
                dc = ((r["t_collective_ms"] - prev["t_collective_ms"])
                      / max(prev["t_collective_ms"], 1))
                dp = r["peak_mem_gb_per_chip"] - prev["peak_mem_gb_per_chip"]
                verdict = f"mem {dm:+.0%}, coll {dc:+.0%}, peak {dp:+.1f}GB"
            out.append(
                f"| {r['variant']} | {r['hypothesis'][:80]} | "
                f"{r['t_memory_ms']:.0f} | {r['t_collective_ms']:.0f} | "
                f"{r['t_compute_ms']:.0f} "
                f"| {r['peak_mem_gb_per_chip']:.1f} | {r['t_run_s']:.1f} "
                f"| {verdict} |")
            prev = r
    return "\n".join(out)


if __name__ == "__main__":
    which = sys.argv[1]
    if which == "roofline":
        print(roofline_table(sys.argv[2]))
    else:
        print(perf_table(sys.argv[2]))
