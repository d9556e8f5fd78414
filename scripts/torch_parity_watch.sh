#!/bin/bash
# Run scripts/torch_learning_parity.py on the card with a watch on the host:
#
#   bash scripts/torch_parity_watch.sh LOGS LIMIT_S PARITY_ARGS...
#
# The runs' --log_dir is a directory of this call's own under /dev/shm
# (their ring checkpoints stay off the disk), removed at the end. Once a
# minute LOGS/monitor.txt gets the seconds since the start, the host's used
# memory, that directory's size, the disk's use, the children's summed RSS
# and bytes written to storage, and the card's memory and utilization. The
# parity script is cut at LIMIT_S; the children's logs and each run's
# progress.txt are copied into LOGS even then. Exits with the script's code.
set -u
LOGS=$1; LIMIT=$2; shift 2
L=$(mktemp -d /dev/shm/parity.XXXXXX)
mkdir -p "$LOGS"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nproc; free -g | sed -n 2p; df -h / /dev/shm | tail -2
( t0=$(date +%s); while true; do
    pids=$(pgrep -f -- '--child' | tr '\n' ' ')
    wb=0; for p in $pids; do w=$(awk '/^write_bytes/{print $2}' /proc/$p/io 2>/dev/null); wb=$((wb + ${w:-0})); done
    echo "t=$(( $(date +%s) - t0 )) mem_used_gib=$(free -g | awk 'NR==2{print $3}') shm=$(du -sh $L 2>/dev/null | cut -f1) root_used=$(df -h / | awk 'NR==2{print $3}') rss_kib=$(ps -o rss= -p ${pids:-1} 2>/dev/null | awk '{s+=$1} END{print s}') child_write_bytes=$wb gpu=$(nvidia-smi --query-gpu=memory.used,utilization.gpu --format=csv,noheader)"
    sleep 60; done ) > "$LOGS/monitor.txt" 2>&1 &
M=$!
timeout -k 20 "$LIMIT" python scripts/torch_learning_parity.py "$@" --log_dir "$L"
rc=$?
kill $M
cp "$L"/*.log "$LOGS"/ 2>/dev/null
find "$L" -name progress.txt | while read -r p; do cp "$p" "$LOGS/$(echo "${p#$L/}" | tr / _)"; done
rm -rf "$L"
tail -3 "$LOGS/monitor.txt"
echo "rc=$rc"
exit $rc
