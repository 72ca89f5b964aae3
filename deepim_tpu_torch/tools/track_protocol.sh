#!/bin/bash
# The learned-tracking path on one card, in one time budget:
#   (a) benchmark_multiclass at 256^2, 13 classes: 15 epochs with
#       TRAIN_ITER_SIZE 2, then TRAIN_ITER_SIZE 4 in chunks to 30, 45 and
#       60 epochs, lr 2e-4 (each chunk a process that resumes the last);
#       the last chunk evaluates;
#   (b) track_learned from the epoch-60 checkpoint: 2 iterations a frame,
#       2 with 4 lock-on iterations, 4 with 4 lock-on iterations;
#   (c) track_finetune (20 epochs from epoch 60), then track_learned of
#       its epoch-80 checkpoint in the same three variants.
# Each step runs under `timeout` with what is left of the budget less a
# reserve for (b); a training chunk that does not finish ends the training,
# and (b) tracks the newest checkpoint there is.  (c) runs only when the
# budget left covers its estimate (the devkit plus 20 epochs at the speed
# of the first chunk, plus the tracks).
#
#   bash deepim_tpu_torch/tools/track_protocol.sh <log dir> [budget s, default 3400] [devkit dir]
#
# Logs: <log dir>/<step>.log, and <log dir>/summary.log (every step's
# exit code and seconds, the TRACK_JSON and BENCH13_JSON lines, each
# epoch's line; protocol_steps.sh).
set -u
LOG=${1:?log directory}
BUDGET=${2:-3400}
DEVKIT=${3:-deepim_tpu_torch/_build/a1_256}
RESERVE=300
. "$(dirname "$0")/protocol_steps.sh"

A="deepim_tpu_torch.tools.benchmark_multiclass --size 256 --classes 13 --lr 2e-4 --out $DEVKIT"
T0=$SECONDS
trained=0
if step a_tis2_15 $RESERVE $A --train-iter-size 2 --epochs 15 --train-only; then
  trained=15
  CHUNK1=$((SECONDS - T0))
  for ep in 30 45 60; do
    flags="--train-only"
    [ "$ep" = 60 ] && flags=""
    step "a_tis4_$ep" $RESERVE $A --train-iter-size 4 --epochs $ep --resume-epoch $trained $flags || break
    trained=$ep
  done
fi
EPOCH=$(newest_epoch "$DEVKIT/run/bench13_ckpt")
say "training ended at epoch $trained; newest checkpoint ${EPOCH:-none}"
[ -z "$EPOCH" ] && exit 1

TL="deepim_tpu_torch.tools.track_learned --size 256 --classes 13 --devkit $DEVKIT"
rc=0
step b_ipf2 0 $TL --epochs "$EPOCH" --iters-per-frame 2 || rc=1
step b_ipf2_init4 0 $TL --epochs "$EPOCH" --iters-per-frame 2 --init-iters 4 || rc=1
step b_ipf4_init4 0 $TL --epochs "$EPOCH" --iters-per-frame 4 --init-iters 4 || rc=1

if [ "$trained" = 60 ]; then
  # 20 epochs of 3,328 pairs at TRAIN_ITER_SIZE 2, timed as the first chunk
  # (which also generated a devkit of the same size), and three tracks.
  EST=$((CHUNK1 * 20 / 15 + 200))
  LEFT=$((BUDGET - SECONDS))
  if [ "$LEFT" -gt "$EST" ]; then
    if step c_finetune 120 deepim_tpu_torch.tools.track_finetune --size 256 --epochs 60 --finetune-epochs 20 \
        --devkit "$DEVKIT"; then
      FT="$TL --prefix trackft --run-dir ${DEVKIT}_trackft/run --epochs 80"
      step c_ipf2 0 $FT --iters-per-frame 2 || rc=1
      step c_ipf2_init4 0 $FT --iters-per-frame 2 --init-iters 4 || rc=1
      step c_ipf4_init4 0 $FT --iters-per-frame 4 --init-iters 4 || rc=1
    else
      rc=1
    fi
  else
    say "c: skipped, $LEFT s left against an estimate of $EST s"
  fi
fi
say "total ${SECONDS} s"
exit $rc
