"""Offline result analysis (port of ``i2pnet_tpu/eval/analysis.py``; it
reads either package's files).

recall_analysis == ref evaluation_analysis.py:31-71 (thresholded mean±std +
recall from saved metrics npz). parse_prediction_file == ref
evaluation_cmrresult.py:31-104 (re-parse section-framed prediction.txt into
per-sample extrinsics and recompute RTE/RRE; multi-seed aggregation).
"""

from __future__ import annotations

import glob
import math
from typing import Dict, List, Sequence

import numpy as np

from i2pnet_tpu_torch import metrics as M
from i2pnet_tpu_torch.eval.evaluator import SECTION


def recall_analysis(
    npz_path: str, rre_th: float = 10.0, rte_th: float = 5.0
) -> Dict[str, float]:
    """Thresholded stats + recall from a metrics npz (RRE/RTE arrays)."""
    data = np.load(npz_path)
    rre, rte = data["RRE"], data["RTE"]
    mask = (rre < rre_th) & (rte < rte_th)
    recall = float(mask.mean()) if len(mask) else float("nan")
    out = {
        "recall": recall,
        "count": int(len(rre)),
        "rre_mean_all": float(rre.mean()),
        "rte_mean_all": float(rte.mean()),
    }
    if mask.any():
        out.update(
            rre_mean=float(rre[mask].mean()),
            rre_std=float(math.sqrt(np.var(rre[mask]))),
            rte_mean=float(rte[mask].mean()),
            rte_std=float(math.sqrt(np.var(rte[mask]))),
            rre_median=float(np.median(rre[mask])),
            rte_median=float(np.median(rte[mask])),
        )
    return out


def parse_prediction_file(path: str) -> Dict[str, np.ndarray]:
    """Parse a prediction.txt back into (init, pred, gt) extrinsic stacks."""
    mats: Dict[str, List[np.ndarray]] = {"init": [], "pred": [], "gt": []}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(SECTION):
                continue
            name, *vals = line.split()
            if name in mats:
                mats[name].append(
                    np.asarray([float(v) for v in vals]).reshape(3, 4)
                )
    return {k: np.stack(v) for k, v in mats.items() if v}


def prediction_file_metrics(path: str) -> Dict[str, float]:
    """Recompute RTE/RRE (+medians) from a prediction file
    (ref evaluation_cmrresult.py:31-79)."""
    mats = parse_prediction_file(path)
    rre, rte = M.rte_rre(mats["pred"], mats["gt"])
    return {
        "rre_mean": float(rre.mean()),
        "rte_mean": float(rte.mean()),
        "rre_median": float(np.median(rre)),
        "rte_median": float(np.median(rte)),
        "count": len(rre),
    }


def aggregate_seeds(pattern: str) -> Dict[str, float]:
    """Aggregate prediction files across seeds (ref cmr_test.bash protocol +
    evaluation_cmrresult.py)."""
    per_seed = [prediction_file_metrics(p) for p in sorted(glob.glob(pattern))]
    if not per_seed:
        return {}
    keys = ("rre_mean", "rte_mean", "rre_median", "rte_median")
    out = {}
    for k in keys:
        vals = np.asarray([m[k] for m in per_seed])
        out[k] = float(vals.mean())
        out[k + "_std"] = float(vals.std())
    out["seeds"] = len(per_seed)
    return out


def main(argv=None):
    """CLI mirroring ref evaluation_analysis.py / evaluation_cmrresult.py:
    re-derive metrics from saved artifacts."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description="re-analyze saved eval artifacts")
    ap.add_argument("path", help="prediction.txt, prediction*.txt glob, or "
                                 "metrics_*.npz")
    ap.add_argument("--rre_th", type=float, default=10.0)
    ap.add_argument("--rte_th", type=float, default=5.0)
    args = ap.parse_args(argv)

    if args.path.endswith(".npz"):
        out = recall_analysis(args.path, rre_th=args.rre_th, rte_th=args.rte_th)
    elif any(ch in args.path for ch in "*?["):
        out = aggregate_seeds(args.path)
    else:
        out = prediction_file_metrics(args.path)
    print(json.dumps(out, indent=2, default=float))


if __name__ == "__main__":
    main()
