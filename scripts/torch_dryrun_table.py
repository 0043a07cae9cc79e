"""Print the dry run's cells as a Markdown table: a row per architecture,
a column per (shape x mesh), the single-pod (16 x 16) and multi-pod
(2 x 16 x 16) meshes side by side.

Run after ``python -m repro_torch.launch.dryrun --mesh both``:

    PYTHONPATH=src python scripts/torch_dryrun_table.py [results/dryrun_torch]

A cell gives the compute, memory and collective terms in seconds
(``launch/roofline.py``'s H100 constants), the dominant term's initial
(C, M or X), then a rank's argument bytes and its peak of live bytes
(the arguments included) in GB; a refused or failed cell its error's
class; a cell not run, a dash.
"""
import glob
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("single", "multi")


def _cell(r):
    if r is None:
        return "—"
    if not r["ok"]:
        return r["error"].split(":")[0]
    t, m = r["roofline"], r["memory_analysis"]
    dom = {"compute": "C", "memory": "M", "collective": "X"}[t["dominant"]]
    return (f"{t['compute_s']:.3g} / {t['memory_s']:.3g} / "
            f"{t['collective_s']:.3g} {dom}; "
            f"{m['argument_size_in_bytes'] / 1e9:.1f} / "
            f"{m['peak_size_in_bytes'] / 1e9:.1f}")


def main(out=os.path.join(HERE, "..", "results", "dryrun_torch")):
    cells = {}
    for path in sorted(glob.glob(os.path.join(out, "*.json"))):
        r = json.load(open(path))
        if not r.get("variant"):
            cells[(r["arch"], r["shape"], r["mesh"])] = r
    shapes = [s for s in SHAPES if any(k[1] == s for k in cells)]
    cols = [(s, m) for s in shapes for m in MESHES]
    print("| arch | " + " | ".join(
        f"{s}, {'16 x 16' if m == 'single' else '2 x 16 x 16'}"
        for s, m in cols) + " |")
    print("|---" * (len(cols) + 1) + "|")
    for arch in sorted({k[0] for k in cells}):
        print(f"| {arch} | " + " | ".join(
            _cell(cells.get((arch, s, m))) for s, m in cols) + " |")
    ok = sum(r["ok"] for r in cells.values())
    print(f"\n{ok} of {len(cells)} cells ok")


if __name__ == "__main__":
    main(*sys.argv[1:])
