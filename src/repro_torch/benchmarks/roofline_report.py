"""The dry run's roofline tables from the cached records
(``results/dryrun_torch/*.json``, written by ``repro_torch.launch.dryrun``):
the counterpart of ``benchmarks/roofline_report.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_report [--tag TAG]

Prints the table of every cell per mesh: the three terms (H100 data-sheet
constants), the bottleneck, MODEL_FLOPs per rank, the useful fraction and
the estimated peak bytes per rank.  JAX's ``--update`` rewrites a block of
its EXPERIMENTS.md, which the port does not have.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
DRY = os.path.join(ROOT, "results", "dryrun_torch")

ARCH_ORDER = ["llama3.2-1b", "glm4-9b", "deepseek-7b", "tinyllama-1.1b",
              "internvl2-2b", "whisper-base", "zamba2-1.2b", "olmoe-1b-7b",
              "qwen3-moe-235b-a22b", "rwkv6-1.6b"]
CELL_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
#: The meshes' labels: ranks of H100s, not TPU chips.
MESH_LABEL = {"single": "16x16 (data,model)", "multi": "2x16x16 (pod,data,model)"}


def _load(tag_filter=""):
    recs = []
    for f in sorted(glob.glob(os.path.join(DRY, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("tag", "") == tag_filter or (tag_filter == "" and "tag" not in r):
            recs.append(r)
    return recs


def _fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.2f}GiB"


def _ms(s):
    return f"{s*1e3:.1f}"


def paper_scenario(r):
    """Annotate each cell with its paper-§4.1 scenario analogue."""
    bt = r["roofline"]["bottleneck"]
    if bt == "memory":
        return "S1-like (MB: matrix units indifferent)"
    if bt == "compute":
        return "S4-like (CB: matrix-unit ceiling is the limit)"
    return "collective-bound (beyond the paper's single-chip model)"


def roofline_table(recs, mesh):
    lines = [
        "| arch | cell | ranks | compute(ms) | memory(ms) | collective(ms) | "
        "bottleneck | MODEL_FLOPs/rank | useful frac | peak HBM/rank |",
        "|---|---|--:|--:|--:|--:|---|--:|--:|--:|",
    ]
    for arch in ARCH_ORDER + sorted({r["arch"] for r in recs
                                     if r["arch"].startswith("stencil")}):
        for cell in CELL_ORDER + ["t2", "t4"]:
            for r in recs:
                if r["arch"] != arch or r["cell"] != cell or r["mesh"] != mesh:
                    continue
                if not r.get("ok"):
                    lines.append(f"| {arch} | {cell} | - | FAILED: "
                                 f"{r.get('error','')[:60]} |")
                    continue
                t = r["roofline"]
                mf = t.get("model_flops")
                uf = t.get("useful_fraction")
                peak = (r.get("memory") or {}).get("peak_bytes")
                lines.append(
                    f"| {arch} | {cell} | {r.get('n_chips','-')} | "
                    f"{_ms(t['compute_s'])} | {_ms(t['memory_s'])} | "
                    f"{_ms(t['collective_s'])} | **{t['bottleneck']}** | "
                    f"{(mf or 0)/ (r.get('n_chips') or 1)/1e12:.2f}T | "
                    f"{uf if uf is None else round(uf,3)} | {_fmt_bytes(peak)} |")
    return lines


def summary(recs):
    n_ok = sum(1 for r in recs if r.get("ok"))
    by_bottleneck = {}
    for r in recs:
        if r.get("ok"):
            b = r["roofline"]["bottleneck"]
            by_bottleneck[b] = by_bottleneck.get(b, 0) + 1
    return n_ok, len(recs), by_bottleneck


def render(tag=""):
    recs = _load(tag)
    out = []
    n_ok, n, bb = summary(recs)
    out.append(f"**{n_ok}/{n} cells traced OK** "
               f"(bottleneck distribution: {bb}).\n")
    for mesh in ("single", "multi"):
        ranks = 256 if mesh == "single" else 512
        out.append(f"\n### Mesh: {mesh} ({MESH_LABEL[mesh]}, {ranks} H100 ranks)\n")
        out.extend(roofline_table(recs, mesh))
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.roofline_report")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    print(render(args.tag))


if __name__ == "__main__":
    main()
