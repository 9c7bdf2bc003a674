set -o pipefail
mkdir -p chiprun_out/pr18
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
t0=$(date +%s)
python3 chip_smoke.py > chiprun_out/pr18/smoke.log 2> chiprun_out/pr18/smoke.err
echo "SMOKE_RC=$? seconds=$(( $(date +%s) - t0 ))"
tail -c 3000 chiprun_out/pr18/smoke.log | tail -3 | cut -c1-1500
grep '"phase": "replay_cli"' chiprun_out/pr18/smoke.log
tail -5 chiprun_out/pr18/smoke.err
timeout 900 python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda -p no:cacheprovider 2>&1 | tail -5
