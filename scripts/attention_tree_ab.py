"""K4/K7 and K6 kernel times of two or more checkouts on one card, turn by turn.

    python scripts/attention_tree_ab.py --tree parent=outputs/parent \
        --tree change=. [--turns parent,change,change,parent] \
        [--out chiprun_out/attention_ab.json]

Each turn is a process of its own run from the tree's root: it imports
that tree's ``chip_smoke`` and runs its ``phase_attention`` (K4/K7) and
``phase_paged_attention`` (K6), or one of them (``--phases``), which build the tree's kernels, hold each
output against its plain version and time it (``Timer.steady``: CUDA-graph
replays over rotating input copies).  Rows are compared by name: per
tree the median of its turns, and its ratio to the first tree's where
both have the row.  The default turns run the trees in order, then in
reverse (a, b, b, a for two).  Needs a CUDA card; nothing here imports JAX.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

TURN = """
import collections, json, sys
import torch
import chip_smoke as S
from gptq_v2_tpu_torch.ops import _cuda
_cuda.build_all(("contiguous_attention", "paged_attention"))
timer = S.Timer(torch)
launches = collections.defaultdict(int)
phases = {"contiguous": S.phase_attention, "paged": S.phase_paged_attention}
rows = [r for p in sys.argv[2].split(",") for r in phases[p](torch, timer, launches)]
json.dump({r["name"]: r["ms"] for r in rows}, open(sys.argv[1], "w"))
"""


def run_turn(root: Path, out: Path, phases: str, log) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    subprocess.run([sys.executable, "-c", TURN, str(out), phases], cwd=root, env=env, check=True,
                   stdout=log, stderr=subprocess.STDOUT)
    return json.loads(out.read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, help="name=path, two or more")
    ap.add_argument("--turns", default=None, help="tree names in order (default a,b,b,a)")
    ap.add_argument("--phases", default="contiguous,paged",
                    help="the smoke's K4/K7 phase (contiguous), K6 phase (paged) or both")
    ap.add_argument("--out", default="chiprun_out/attention_ab.json")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    if len(trees) < 2:
        raise SystemExit("give two trees or more")
    names = list(trees)
    turns = args.turns.split(",") if args.turns else names + names[::-1]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    times = {name: [] for name in trees}
    with open(out.with_suffix(".log"), "w") as log, tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(turns):
            got = run_turn(Path(trees[name]).resolve(), Path(tmp) / f"turn{i}.json",
                           args.phases, log)
            times[name].append(got)
            print(f"turn {i} {name}: {len(got)} rows", flush=True)
    first = names[0]
    rows = {}
    for row in sorted(set().union(*(t for runs in times.values() for t in runs))):
        med = {name: statistics.median(t[row] for t in runs)
               for name, runs in times.items() if all(row in t for t in runs)}
        rows[row] = dict(ms=med, ratio={name: ms / med[first] for name, ms in med.items()
                                        if first in med and name != first})
    summary = {}
    for name in names[1:]:
        ratios = sorted(r["ratio"][name] for r in rows.values() if name in r["ratio"])
        summary[name] = dict(rows=len(ratios), ratio_min=ratios[0],
                             ratio_median=statistics.median(ratios), ratio_max=ratios[-1])
    out.write_text(json.dumps(dict(turns=turns, summary=summary, rows=rows, times=times),
                              indent=1))
    for row, r in rows.items():
        print(f"{row}: " + ", ".join(f"{n} {ms:.4f}" for n, ms in r["ms"].items()) + " ms; "
              + ", ".join(f"{n}/{first} {x:.3f}" for n, x in r["ratio"].items()))
    print(json.dumps(dict(turns=turns, summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
