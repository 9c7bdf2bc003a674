#!/bin/bash
# Time-shard gather A/B on one card:
#
#     bash ab.sh PARENT CHANGE OUT
#
# PARENT and CHANGE are unpacked checkouts (`git archive`) of the parent
# and the change; logs go to OUT. The change's time-shard card tests run
# first (stop on a failure), then parent, change, change, parent through
# the change's chip_smoke.py --timeshard-only (in the parent's checkout
# through parent_compat.py, which lies beside this script), then the
# change's whole card test file.
set -u
PARENT=$(realpath "$1") CHANGE=$(realpath "$2") OUT=$(realpath -m "$3")
HERE=$(dirname "$(realpath "$0")")
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
cd "$CHANGE"
t=$SECONDS
timeout 300 python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider \
  -k timeshard > "$OUT/r_ts_tests.log" 2>&1
rc=$?
echo "timeshard card tests rc=$rc $((SECONDS - t))s"; tail -2 "$OUT/r_ts_tests.log"
[ $rc = 0 ] || exit 1
cp "$CHANGE/chip_smoke.py" "$HERE/parent_compat.py" "$PARENT/"

run() {  # tag dir script [args]
  local tag=$1 dir=$2; shift 2
  rm -rf "$dir/rtl_433_tpu_torch/_build"
  cd "$dir"
  local t=$SECONDS
  timeout 600 python3 "$@" > "$OUT/r_$tag.log" 2> "$OUT/r_$tag.err"
  local rc=$?
  echo "$tag rc=$rc $((SECONDS - t))s $(tail -1 "$OUT/r_$tag.log" | cut -c1-100)"
}
run ab_parent1 "$PARENT" parent_compat.py
run ab_change1 "$CHANGE" chip_smoke.py --timeshard-only
run ab_change2 "$CHANGE" chip_smoke.py --timeshard-only
run ab_parent2 "$PARENT" parent_compat.py
cd "$CHANGE"
t=$SECONDS
timeout 400 python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider \
  > "$OUT/r_cuda_tests.log" 2>&1
echo "card tests rc=$? $((SECONDS - t))s"; tail -2 "$OUT/r_cuda_tests.log"
