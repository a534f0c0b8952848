#!/usr/bin/env bash
# Real multi-process distributed execution (the reference's `mpiexec -n 4`
# CI axis, test/LinearSolvers/mpi/runtests.jl): N OS processes x 2 CPU
# devices each, joined via jax.distributed + gloo collectives, running
# the GMG-CG and Stokes flagships on global jax.Arrays whose shards
# cross real process boundaries. Rank 0 prints MULTIPROC_RESULT <json>.
#
# Usage: scripts/run_multiproc.sh [NPROCS] [PORT]
set -u
NPROCS="${1:-4}"
PORT="${2:-45991}"
HERE="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$HERE${PYTHONPATH:+:$PYTHONPATH}"
TMP="$(mktemp -d)"
pids=()
for ((i = 0; i < NPROCS; i++)); do
  timeout 900 python "$HERE/scripts/multiproc_worker.py" "$i" "$NPROCS" "$PORT" \
    >"$TMP/rank$i.log" 2>&1 &
  pids+=($!)
done
rc=0
for p in "${pids[@]}"; do
  wait "$p" || rc=$?
done
if [[ $rc -ne 0 ]]; then
  echo "FAILED (rc=$rc); rank logs:" >&2
  tail -n 20 "$TMP"/rank*.log >&2
  exit "$rc"
fi
grep -h "^MULTIPROC_RESULT" "$TMP"/rank0.log
rm -rf "$TMP"
