#!/usr/bin/env bash
# The 10-seed small-range evaluation protocol (KITTI odometry, the CMRNet
# protocol) through the PyTorch port: evaluate_torch.py with 10 fixed
# decalibration seeds, then the port's aggregate_seeds over the ten
# prediction files. The twin of scripts/cmr_test.sh, with the same arguments.
#
# Usage: scripts/cmr_test_torch.sh <root_path> <model_dir> [log_dir] [test_rt_dir] [device]
#   test_rt_dir: optional directory of the per-seed pickles
#   (test_RT_seq00_10.00_2.00_<tag>.pkl); without it each seed uses the
#   deterministic table generated from the seed.
#   device: cuda (the default) or cpu; also read from $I2PNET_DEVICE.
set -euo pipefail
ROOT=${1:?root_path}
MODEL=${2:?model_dir}
LOG=${3:-info_test_cmr}
RTDIR=${4:-}
DEVICE=${5:-${I2PNET_DEVICE:-cuda}}

for seed in 0 1 2 3 4 5 6 7 8 9; do
  EXTRA=()
  if [ -n "$RTDIR" ]; then
    RT=$(python3 -c "from i2pnet_tpu_torch.data.preprocess import cmr_test_rt_path; print(cmr_test_rt_path('$RTDIR', '00', 10.0, 2.0, $seed))")
    EXTRA=(--test_rt "$RT")
  fi
  python3 evaluate_torch.py --dataset kd_cmr_snr --network i2pnet \
    --root_path "$ROOT" --model_dir "$MODEL" --device "$DEVICE" \
    --log_dir "$LOG" --seed "$seed" --tag "_seed${seed}" "${EXTRA[@]}"
done

python3 - "$LOG" <<'PY'
import sys
from i2pnet_tpu_torch.eval.analysis import aggregate_seeds

agg = aggregate_seeds(f"{sys.argv[1]}/prediction_seed*.txt")
print("== 10-seed aggregate ==")
for k, v in agg.items():
    print(f"  {k}: {v}")
PY
