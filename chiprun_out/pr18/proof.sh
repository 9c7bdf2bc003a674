set -o pipefail
mkdir -p chiprun_out/pr18
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
cd chiprun_proof
t0=$(date +%s)
python3 chip_smoke.py > ../chiprun_out/pr18/proof_smoke.log 2> ../chiprun_out/pr18/proof_smoke.err
rc=$?
echo "PROOF_RC=$rc seconds=$(( $(date +%s) - t0 ))"
tail -2 ../chiprun_out/pr18/proof_smoke.log | cut -c1-300
grep '"phase": "replay_cli"' ../chiprun_out/pr18/proof_smoke.log | cut -c1-1500
d=$(mktemp -d); cp chip_smoke.py "$d"/; (cd "$d" && python3 chip_smoke.py > out.txt 2>&1; echo "ALONE_RC=$?"; tail -c 300 out.txt); rm -rf "$d"
exit $rc
