#!/usr/bin/env bash
# The paper's workload grid (scripts/experiments.sh) through the PyTorch
# port's CLI (gpboi-torch, run here as python3 -m
# gp_bayesopinf_torch.pipeline.cli so that a checkout needs no install),
# then the paper's figures through gp_bayesopinf_torch.viz.paper, which
# imports neither jax nor the JAX package.
#
#   scripts/torch_experiments.sh            # the grid, then the figures
#   scripts/torch_experiments.sh figures    # the figures from data/ only
#
# Each run exports its HDF5 artifacts to data/<pipeline>/<name> with
# --exportto, which needs h5py; the figures need h5py and matplotlib
# (pip install .[viz,io]). The H100 machine the port is measured on has
# neither package: there the grid runs without --exportto (each run
# still prints its summary and writes log.log and report.txt), and the
# figures are drawn from exports made where h5py and matplotlib are.
# DEVICE (default cuda) names the device of every run.
set -euo pipefail

NDRAWS=600
DEVICE=${DEVICE:-cuda}
GPBOI=(python3 -m gp_bayesopinf_torch.pipeline.cli)

if python3 -c "import h5py" 2>/dev/null; then
    EXPORT=1
else
    EXPORT=0
    echo "h5py is not installed: the runs export nothing and no figure is drawn" >&2
fi

# run NAME ARGS...: one workload, exported to data/NAME where h5py is.
run() {
    local name=$1
    shift
    local out=()
    if [ "$EXPORT" = 1 ]; then
        out=(--exportto "data/$name")
    fi
    "${GPBOI[@]}" "$@" --ndraws $NDRAWS --device "$DEVICE" --noopen "${out[@]}"
}

if [ "${1:-}" != "figures" ]; then
    # --- Euler (reference PDEs/experiments.sh:6-30) ----------------------------
    # Noisy data (--ddtdata on ex1a, as the reference's recorded run does).
    run euler/ex1a euler 0.06 200 0.03 400 6 --ddtdata
    run euler/ex1b euler 0.06 200 0.03 50 6
    run euler/ex1c euler 0.06 200 0.03 3200 6
    run euler/ex1d euler 0.06 200 0.01 400 6
    run euler/ex1e euler 0.06 200 0.05 400 6
    # Singular value decay.
    run euler/ex1r8 euler 0.06 200 0.03 400 8
    # Sparse data (--ddtdata on ex2a).
    run euler/ex2a euler 0.06 50 0.01 400 6 --ddtdata
    run euler/ex2b euler 0.06 50 0.01 50 6
    run euler/ex2c euler 0.06 50 0.01 3200 6
    run euler/ex2d euler 0.06 20 0.01 400 6
    run euler/ex2e euler 0.06 80 0.01 400 6

    # --- SEIRD (reference ODEs/experiments.sh:6-18) ----------------------------
    # Noisy data.
    run seird/ex1a seird 90 90 0.10 360
    run seird/ex1c seird 60 60 0.10 240
    run seird/ex1d seird 120 120 0.10 480
    # Sparse data.
    run seird/ex2a seird 120 10 0.05 480
    run seird/ex2c seird 60 10 0.05 240
    run seird/ex2d seird 90 10 0.05 360

    # --- Multi-trajectory cubic heat (reference PDEsMulti/experiments.sh:6) ----
    run heat3/ex3 heat 1.0 20 0.05 80 5
fi

# --- Figures (reference */plots_paper.py paper() functions) -----------------
if [ "$EXPORT" = 1 ]; then
    python3 - <<'EOF'
from gp_bayesopinf_torch.viz.paper import euler_paper, heat_paper, seird_paper

euler_paper(datadir="data/euler", savedir="figures/euler")
seird_paper(datadir="data/seird", savedir="figures/seird")
heat_paper(datadir="data/heat3", savedir="figures/heat")
EOF
fi
