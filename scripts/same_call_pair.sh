#!/bin/bash
# Compare two checkouts of the repository on one card in one command:
# chip_smoke.py of the parent, the change, the change and the parent, in
# turns, each run's output in chiprun_out/pair_<parent|change><1|2>.log;
# then the SASS of the change's X1 transforms (chiprun_out/gf_fft.sass)
# and scripts/pair_summary.py over the four logs and the SASS; then
# scripts/verify_walk_profile.py over the trees in the same turns
# (verify_walks.log beside the four logs).
#
# Usage, from the repository root, with each tree unpacked by git archive
# into a directory that .gitignore lists:
#   scripts/same_call_pair.sh PARENT_DIR CHANGE_DIR
# It exits non-zero if any of the four runs failed.
set -u
root=$(pwd)
out=$root/chiprun_out
mkdir -p "$out"
status=0
for run in parent:1 change:1 change:2 parent:2; do
  side=${run%%:*}
  n=${run##*:}
  if [ "$side" = parent ]; then tree=$1; else tree=$2; fi
  log=$out/pair_$side$n.log
  (cd "$tree" && python3 chip_smoke.py > "$log" 2>&1)
  rc=$?
  [ $rc -eq 0 ] || status=1
  echo "$side $n exit $rc: $(tail -n 1 "$log" | cut -c1-200)"
done
for lib in "$2"/build/torch_kernels/libgf_fft-*.so; do
  "${CUDA_HOME:-/usr/local/cuda}/bin/cuobjdump" -sass "$lib" > "$out/gf_fft.sass"
done
python3 "$root/scripts/pair_summary.py" "$out" || status=1
# the eager and graphed GKR walks of both trees, in turns, with profiles
python3 "$root/scripts/verify_walk_profile.py" "$1" "$2" "$2" "$1" \
  > "$out/verify_walks.log" 2>&1 || status=1
grep -v Warning "$out/verify_walks.log" | cut -c1-3000
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $status
