"""Diff two FinalResults.json files (the reference's vs the port's).

Port of `script/diff_final_results.py` (numpy-free, as it is).

Usage: python -m mhmocap_tpu_torch.diff_final_results REF.json OURS.json
       [--pck-tol 0.5]

Prints a per-sequence delta table for every metric (plain and _univ)
and exits 1 if the Avg. `pck_rel` differs by more than --pck-tol —
the BASELINE.json acceptance criterion (see docs/PARITY.md).

Both files must follow the schema written by eval_mupots
(reference eval_mupots.py:178-186;
`mhmocap_tpu_torch/eval_mupots.py`): {"final_results": {metric:
[TS1..TSn, Avg.]}, "sequences": [...]} — the reference writes the
same keys.
"""

import argparse
import json
import sys


METRICS = ("mm_abs_error", "mm_rel_error", "mm_mrpe", "pck_rel",
           "ap25_root", "abs_jitter")


def load(path):
    with open(path) as f:
        data = json.load(f)
    return data.get("final_results", data)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ref")
    ap.add_argument("ours")
    ap.add_argument("--pck-tol", type=float, default=0.5)
    args = ap.parse_args(argv)

    ref = load(args.ref)
    ours = load(args.ours)

    keys = [k for m in METRICS for k in (m, m + "_univ")
            if k in ref and k in ours]
    if not keys:
        print("no common metric keys found", file=sys.stderr)
        return 2

    n = len(ref[keys[0]])
    rows = [f"TS{i + 1}" for i in range(n - 1)] + ["Avg."]
    print(f"{'seq':>6} " + " ".join(f"{k:>18}" for k in keys))
    for i, row in enumerate(rows):
        deltas = []
        for k in keys:
            d = ours[k][i] - ref[k][i]
            deltas.append(f"{ref[k][i]:7.2f}{d:+8.2f}   ")
        print(f"{row:>6} " + " ".join(deltas))

    dpck = abs(ours["pck_rel"][-1] - ref["pck_rel"][-1])
    print(f"\nAvg. pck_rel delta: {dpck:.3f} (tolerance "
          f"{args.pck_tol})")
    if dpck > args.pck_tol:
        print("FAIL: outside tolerance", file=sys.stderr)
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
