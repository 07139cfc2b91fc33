"""KF-cadence audit from the per-frame record bench.py archives.

bench.py archives the two keyframe-decision inputs per frame
(FullSystem.cpp:1127-1152) to <checkout>/.cache/bench_obs.jsonl: the
weighted flow/affine score `kf_delta` (KF when > 1) and the
(rmse, firstCoarseRMSE) pair (KF when 2*first < rmse). This reports which
term drives each keyframe and how close the stream sits to the thresholds,
so a drifted keyframe cadence becomes attributable.

Run: python tools/analyze_kf_decisions.py [path/to/bench_obs.jsonl]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".cache", "bench_obs.jsonl",
    )
    rows = []
    for line in open(path):
        r = json.loads(line)
        if "kf_delta" in r:
            rows.append(r)
    if not rows:
        print(json.dumps({"error": "no per-frame decision records found "
                          "(re-run bench.py to regenerate them)"}))
        return
    delta = np.array([r["kf_delta"] for r in rows])
    rmse = np.array([r["kf_rmse"] for r in rows])
    first = np.array([r["kf_first_rmse"] for r in rows])
    need = np.array([r["need_kf"] for r in rows])

    flow_term = delta > 1.0
    # first_rmse < 0 encodes "not yet set for this reference"
    rmse_term = (2.0 * first < rmse) & (first >= 0)
    out = {
        "n_frames": len(rows),
        "n_kf": int(need.sum()),
        "kf_rate": round(float(need.mean()), 3),
        "kf_by_flow_delta_only": int((need & flow_term & ~rmse_term).sum()),
        "kf_by_rmse_doubling_only": int((need & ~flow_term & rmse_term).sum()),
        "kf_by_both": int((need & flow_term & rmse_term).sum()),
        # threshold proximity: how much of the stream idles near delta=1
        "delta_p50": round(float(np.median(delta)), 3),
        "delta_p90": round(float(np.percentile(delta, 90)), 3),
        "nonkf_delta_in_0p8_1": int(((~need) & (delta > 0.8)).sum()),
        "rmse_ratio_p50": round(
            float(np.median(rmse / np.maximum(first, 1e-9))), 3
        ),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
