#!/bin/bash
# The port's dry-run sweep on the host, without a card: every runnable
# cell of repro_torch.configs.registry.cells() on both production meshes,
# one process a (cell, mesh) (one fake process group a process), P at a
# time.  Each cell's log and record go to OUT; the OK / FAIL lines and
# each process's wall seconds are printed at the end.
#
#   OUT=artifacts/dryrun_torch P=4 bash tools/dryrun_sweep.sh
#   CELLS="gemma3_1b train_4k multi" bash tools/dryrun_sweep.sh
#
# Exits 1 if any cell failed.
cd "$(dirname "$0")/.."
export PYTHONPATH=src CUDA_VISIBLE_DEVICES=
OUT=${OUT:-artifacts/dryrun_torch}
P=${P:-4}
mkdir -p "$OUT"
python3 -c 'import sys, torch; print("python", sys.version.split()[0], "torch", torch.__version__)'
CELLS=${CELLS:-$(python3 -c '
from repro_torch.configs.registry import cells
for a, s, ok in cells():
    if ok:
        for m in ("single", "multi"):
            print(a, s, m)')}
SECONDS=0
echo "$CELLS" | OUT="$OUT" xargs -P "$P" -L 1 bash -c '
t0=$SECONDS
python3 -m repro_torch.launch.dryrun --arch $0 --shape $1 --mesh $2 \
    --out "$OUT" > "$OUT/$0.$1.$2.log" 2>&1
echo "rc=$? wall=$((SECONDS - t0))s" >> "$OUT/$0.$1.$2.log"'
echo "sweep wall ${SECONDS}s"
grep -h "^OK\|^FAIL" "$OUT"/*.log | sort
for f in "$OUT"/*.log; do echo "$(basename "$f" .log) $(tail -n 1 "$f")"; done
! grep -q "rc=[1-9]" "$OUT"/*.log
