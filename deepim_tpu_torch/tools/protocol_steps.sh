# Shared by the card protocols (track_protocol.sh, a1_protocol.sh), sourced
# after they set LOG (the log directory) and BUDGET (seconds for the whole
# protocol, counted on bash's SECONDS).  Defines:
#   say <text>: print and append to $LOG/summary.log;
#   step <name> <reserve s> <module> [arguments...]: `python -u -m` the module
#       under `timeout` with what is left of the budget less the reserve,
#       its output in $LOG/<name>.log; records its exit code and seconds and
#       the lines a reader compares (the runners' JSON lines and tables, each
#       epoch's line, the seeding and run lines) in the summary; returns the
#       module's exit code, or 99 when less than 60 s would be left;
#   newest_epoch <checkpoint dir>: the largest epoch saved there (empty if none).
# It starts the summary with the card's name and power limit and the
# Python, torch and CUDA versions.
mkdir -p "$LOG"
SUMMARY="$LOG/summary.log"
: > "$SUMMARY"
say() { echo "$*" | tee -a "$SUMMARY"; }

say "card: $(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>&1 | head -1)"
say "$(python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)')"

step() {
  local name=$1 reserve=$2; shift 2
  local left=$((BUDGET - SECONDS - reserve))
  if [ "$left" -lt 60 ]; then
    say "$name: skipped, ${left} s left of the budget"
    return 99
  fi
  local t0=$SECONDS
  timeout -k 10 "$left" python -u -m "$@" > "$LOG/$name.log" 2>&1
  local rc=$?
  say "$name: rc $rc, $((SECONDS - t0)) s (limit $left s)"
  grep -h "^BENCH13_JSON\|^BENCH_OCC_JSON\|^TRACK_JSON\|^run: \|^track: \|^seeded \|^epoch [0-9]*: \|^| \(init\|iter\|[0-9]\) " \
    "$LOG/$name.log" | tee -a "$SUMMARY"
  return $rc
}

newest_epoch() { ls "$1" 2>/dev/null | grep -E '^[0-9]+$' | sort -n | tail -1; }
