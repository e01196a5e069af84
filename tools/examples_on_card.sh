#!/bin/bash
# Runs the port's four examples on the card (serve_lm.py in each mode),
# then their card tests, from the repository root.  Each command's whole
# output goes to chiprun_out/examples/<name>.log; its exit code and wall
# seconds to chiprun_out/examples/summary.txt.  Exits non-zero if any
# command failed.
#
#   bash tools/examples_on_card.sh
cd "$(dirname "$0")/.." || exit 1
export PYTHONPATH=src
out=chiprun_out/examples
mkdir -p $out
: > $out/summary.txt
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee $out/card.txt
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
failed=0
run() {
  local name=$1; shift
  local t0 t1 rc
  t0=$(date +%s.%N)
  "$@" > $out/$name.log 2>&1
  rc=$?
  t1=$(date +%s.%N)
  [ $rc -eq 0 ] || failed=1
  python -c "print('== $name rc=$rc wall=%.1f s' % ($t1 - $t0))" | tee -a $out/summary.txt
  tail -n "${TAILN:-12}" $out/$name.log
}
run quickstart python examples/torch_port/quickstart.py
run serve_none python examples/torch_port/serve_lm.py
run serve_int8 python examples/torch_port/serve_lm.py --quantize int8
run serve_w8a8 python examples/torch_port/serve_lm.py --quantize w8a8
TAILN=6 run serve_chaos python examples/torch_port/serve_lm.py --chaos --quantize int8 --metrics
run train_lm python examples/torch_port/train_lm.py
run distributed_gemm python examples/torch_port/distributed_gemm.py
TAILN=8 run cuda_tests python -m pytest --noconftest -p no:cacheprovider -m cuda -q tests/test_torch_cuda.py -k example -rs
grep -h "chaos:" $out/serve_chaos.log
cat $out/summary.txt
exit $failed
