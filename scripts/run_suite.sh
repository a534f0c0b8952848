#!/usr/bin/env bash
# Full-suite runner: one pytest process PER TEST FILE, J files in parallel.
#
# Why not one process: a single-process run of the whole suite (230+
# tests) accumulates XLA CPU compile-cache/collective state and has
# crashed fatally at scale (round-2 verdict); per-file isolation bounds
# that state, keeps peak RSS flat, and lets files run under their own
# timeout. CI (.github/workflows/ci.yml) chunks the same way.
#
# Parallelism: much of a file's wall time is single-threaded XLA
# compilation, so files overlap well even on few cores. J defaults to 3
# (machine has 4 cores); serialize with J=1.
#
# Usage: [J=3] scripts/run_suite.sh [extra pytest args]
# Exit code 0 iff every file passed.
set -u
cd "$(dirname "$0")/.."
J="${J:-3}"
START=$(date +%s)
mkdir -p ${TMPDIR:-/tmp}/suite_logs

run_one() {
  f="$1"; shift
  t0=$(date +%s)
  if timeout 1500 python -m pytest "$f" -q -p no:cacheprovider "$@" \
      > "${TMPDIR:-/tmp}/suite_logs/$(basename "$f").log" 2>&1; then
    status=ok
  else
    status=FAIL
  fi
  dt=$(( $(date +%s) - t0 ))
  printf "%-32s %-5s %4ds\n" "$(basename "$f")" "$status" "$dt"
}
export -f run_one

printf "%s\n" tests/test_*.py \
  | xargs -P "$J" -I{} bash -c 'run_one "$@"' _ {} "$@" \
  | tee ${TMPDIR:-/tmp}/suite_logs/summary.txt

echo "----"
sort -k3 -n -r ${TMPDIR:-/tmp}/suite_logs/summary.txt | head -8
FAIL=0
if grep -q FAIL ${TMPDIR:-/tmp}/suite_logs/summary.txt; then
  FAIL=1
  for f in $(awk '$2=="FAIL"{print $1}' ${TMPDIR:-/tmp}/suite_logs/summary.txt); do
    echo "=== $f ==="; tail -30 "${TMPDIR:-/tmp}/suite_logs/$f.log"
  done
fi
echo "total: $(( $(date +%s) - START ))s  exit=$FAIL"
exit $FAIL
