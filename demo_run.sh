#!/bin/bash
# The JAX demo run (runs/train/demo/opt.json) trained by the port on the
# card, then its best scored in every serving mode by tools/eval_modes, in
# one process tree: a flagship checkpoint is ~523 MB, so the run and its
# scoring stay on one machine and only the logs and JSON lines go to the
# output directory (~23 min on one H100). The run directory is the one
# cli.train reports on its first JSON line (runs/train/demo, numbered on).
#
#   bash demo_run.sh [output dir, default runs/demo_logs]
set -o pipefail
O=${1:-runs/demo_logs}
mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/card.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' | tee -a "$O/card.txt"
T0=$(date +%s)
python -u -m rep_yolo_tpu_torch.cli.train --data synthetic:768 --val-data synthetic:128 \
  --epochs 24 --batch-size 8 --img-size 640 --hyp scratch.p5 --eval-every 3 --name demo \
  2> "$O/train.err" | grep -v '^{"epoch": [0-9]*, "step"' > "$O/train.log"
rc=$?
T1=$(date +%s); echo "train rc $rc seconds $((T1 - T0))"
cat "$O/train.log"
if [ $rc -ne 0 ]; then tail -30 "$O/train.err"; exit $rc; fi
R=$(sed -n 's/.*"run_dir": "\([^"]*\)".*/\1/p' "$O/train.log" | head -n 1)
if [ ! -d "$R" ]; then echo "no run directory in $O/train.log"; exit 7; fi
for f in results.txt metrics.csv hyp.json opt.json anchors.json best.json last.json; do
  cp "$R/$f" "$O/" || exit 7
done
python -u -m rep_yolo_tpu_torch.tools.eval_modes --weights "$R/best" \
  --val-data synthetic:128 > "$O/modes.jsonl" 2> "$O/modes.err"
rc=$?
T2=$(date +%s); echo "modes rc $rc seconds $((T2 - T1))"
cat "$O/modes.jsonl"
if [ $rc -ne 0 ]; then tail -30 "$O/modes.err"; fi
exit $rc
