#!/bin/bash
# Long-run oneBD convergence A/B: reference-faithful stochastic background
# vs deterministic-expectation background (-deterministicBG), 400+400
# steps x 256 walkers x 200k draws on the GPU.  Writes chains + results
# under out/detbg_study/.  The two fits run one after the other: one JAX
# process per card.
set -e
cd "$(dirname "$0")/.."
OUT=out/detbg_study
mkdir -p $OUT

echo "=== deterministic background (800 steps) ==="
python -m mcmctoffitting_tpu.cli.csi_onebd \
    -nBurninSteps 400 -nMainSteps 400 -batch 1 -deterministicBG \
    -chunkWalkers 32 -segment 10 -outputPrefix $OUT/detbg_ \
    | tee $OUT/detbg_log.txt

echo "=== faithful stochastic background (800 steps) ==="
python -m mcmctoffitting_tpu.cli.csi_onebd \
    -nBurninSteps 400 -nMainSteps 400 -batch 1 \
    -chunkWalkers 32 -segment 10 -outputPrefix $OUT/faithful_ \
    | tee $OUT/faithful_log.txt

python tools/onebd_convergence_report.py $OUT
