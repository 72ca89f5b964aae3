#!/bin/bash
# A1's 480x640 and occlusion protocols on one card, in one time budget (the
# JAX package's round-5 queue: experiments/run_r5_chip_queue.sh P1a and
# experiments/run_r5_chip_queue5.sh P1b-P3):
#   (a) the 256^2 base: benchmark_multiclass --size 256 --classes 13 --lr
#       2e-4, 15 epochs at TRAIN_ITER_SIZE 2, then TRAIN_ITER_SIZE 4 resumed
#       to epoch 30, training only (track_protocol.sh's first two steps);
#   (b) 480x640 in a devkit of its own: 128 training pairs a class, batch 16,
#       TRAIN_ITER_SIZE 4, lr 1e-4, every layer but fc6 seeded from (a)'s
#       epoch 30 (--seed-convs); two 4-epoch chunks, each a process that
#       derives its lr steps from its own --epochs (at 2 and 3, then at 5
#       and 6, as JAX's run), then --test-only at epoch 8 (BENCH13_JSON);
#   (c) the occlusion fine-tune from (a)'s epoch 30: 30 epochs on 256
#       scenes, then its test (BENCH_OCC_JSON).  It runs only when the
#       budget left covers its estimate: twice (a)'s TRAIN_ITER_SIZE-4
#       chunk, which trains 15 epochs at the fine-tune's frame, batch, depth
#       and 3,328 samples an epoch, plus 200 s for its scenes and test.
# Each step runs under `timeout` with what is left of the budget less a
# reserve for (b)'s test.  A chunk that does not finish ends the training
# before it: (b) then seeds from, or tests, the newest checkpoint there is,
# and the summary says that it is not the epoch the protocol names.
#
#   bash deepim_tpu_torch/tools/a1_protocol.sh <log dir> [budget s, default 3400] [work dir]
#
# Logs: <log dir>/<step>.log, and <log dir>/summary.log (the card line,
# every step's exit code and seconds, each epoch's line, the BENCH13_JSON
# and BENCH_OCC_JSON lines and the tables; protocol_steps.sh).
set -u
LOG=${1:?log directory}
BUDGET=${2:-3400}
WORK=${3:-deepim_tpu_torch/_build/a1}
RESERVE=200
BASE=$WORK/base_256
HIRES=$WORK/hires_480x640
. "$(dirname "$0")/protocol_steps.sh"

A="deepim_tpu_torch.tools.benchmark_multiclass --size 256 --classes 13 --lr 2e-4 --out $BASE"
rc=0
CHUNK2=
if step a_tis2_15 $RESERVE $A --train-iter-size 2 --epochs 15 --train-only; then
  t0=$SECONDS
  step a_tis4_30 $RESERVE $A --train-iter-size 4 --epochs 30 --resume-epoch 15 --train-only && CHUNK2=$((SECONDS - t0))
fi
SEED=$(newest_epoch "$BASE/run/bench13_ckpt")
[ -z "$SEED" ] && { say "(a) saved no checkpoint"; exit 1; }
if [ "$SEED" != 30 ]; then
  say "(a) ended at epoch $SEED: (b) and (c) start from epoch $SEED, not the protocol's 30"
  rc=1
fi

B="deepim_tpu_torch.tools.benchmark_multiclass --size 480 --width 640 --train-iter-size 4 --classes 13 --batch 16"
B="$B --lr 1e-4 --n-train 128 --out $HIRES"
if step b_ep4 $RESERVE $B --epochs 4 --seed-convs "$BASE/run/bench13" --seed-epoch "$SEED" --train-only; then
  step b_ep8 $RESERVE $B --epochs 8 --resume-epoch 4 --train-only
fi
EPOCH=$(newest_epoch "$HIRES/run/bench13_ckpt")
[ -z "$EPOCH" ] && { say "(b) saved no checkpoint"; exit 1; }
if [ "$EPOCH" != 8 ]; then
  say "(b) ended at epoch $EPOCH: testing epoch $EPOCH, not the protocol's 8"
  rc=1
fi
step b_test 0 $B --epochs "$EPOCH" --test-only || rc=1

LEFT=$((BUDGET - SECONDS))
if [ -n "$CHUNK2" ] && [ "$SEED" = 30 ]; then
  EST=$((CHUNK2 * 2 + 200))
  if [ "$LEFT" -gt "$EST" ]; then
    step c_occlusion 0 deepim_tpu_torch.tools.benchmark_occlusion --size 256 --epochs 30 --train-scenes 256 \
      --finetune-epochs 30 --out "$BASE" || rc=1
  else
    say "c: skipped, $LEFT s left against an estimate of $EST s (twice (a)'s 15-epoch chunk of $CHUNK2 s, plus 200)"
  fi
else
  say "c: skipped, (a) did not reach epoch 30"
fi
say "total ${SECONDS} s"
exit $rc
