#!/usr/bin/env bash
# End-to-end walkthrough of the cohort workflow on the PyTorch port
# (spark_examples_tpu_torch): the same steps as ancestry_workflow.sh,
# which runs the JAX package. Every verb runs on --device "$DEVICE":
# the card (cuda) unless DEVICE=cpu is set (a few minutes on the CPU).
#
#   1. simulate a reference panel and a new cohort at shared sites
#   2. per-sample and cross-cohort QC (sample-stats, cross-kinship)
#   3. one-pass ETL into the 2-bit packed store with QC + LD pruning
#   4. fit PCoA on the panel, persist the embedding model
#   5. project the new cohort into the panel's coordinate space
#
# Every step prints what it produced (its first lines: `sed -n`, which
# reads the whole stream, so a verb still printing never meets a closed
# pipe under pipefail); all outputs land in ./workflow_out_torch.
set -euo pipefail

RUN="python -m spark_examples_tpu_torch"
DEVICE="${DEVICE:-cuda}"
OUT=workflow_out_torch
mkdir -p "$OUT"

echo "== 1. simulate cohorts (shared variant set) =="
python - "$OUT" <<'EOF'
import sys

import numpy as np

from spark_examples_tpu_torch.ingest.plink import write_plink

out = sys.argv[1]
rng = np.random.default_rng(0)
n_panel, n_new, v, pops = 120, 12, 20_000, 3
labels = rng.integers(0, pops, n_panel + n_new)
p = (0.05 + 0.9 * rng.random((pops, v)))[labels]
g = ((rng.random((len(labels), v)) < p).astype(np.int8)
     + (rng.random((len(labels), v)) < p).astype(np.int8))
g[rng.random(g.shape) < 0.01] = -1
write_plink(f"{out}/panel", g[:n_panel])
write_plink(f"{out}/newcohort", g[n_panel:])
np.save(f"{out}/labels.npy", labels)
print(f"panel {n_panel} samples, new cohort {n_new}, {v} shared variants")
EOF

echo "== 2a. per-sample QC =="
$RUN sample-stats --device "$DEVICE" --source plink --path "$OUT/panel" \
    --output-path "$OUT/panel_sample_stats.tsv" | sed -n 1,3p

echo "== 2b. cross-cohort relatedness screen =="
$RUN cross-kinship --device "$DEVICE" --source plink --path "$OUT/newcohort" \
    --ref-source plink --ref-path "$OUT/panel" \
    --output-path "$OUT/cross_phi.tsv" | sed -n 1,3p

echo "== 3. ETL: QC + LD-prune the panel into a packed store =="
$RUN pack --device "$DEVICE" --source plink --path "$OUT/panel" \
    --maf 0.01 --max-missing 0.1 --ld-prune-r2 0.5 \
    --output-path "$OUT/panel_store"

echo "== 4. fit PCoA on the QC+pruned panel store (panel-only coords) =="
$RUN pcoa --device "$DEVICE" --source packed --path "$OUT/panel_store" --num-pc 4 \
    --output-path "$OUT/panel_coords.tsv" | sed -n 1,2p

echo "== 5. fit a projectable model + project the new cohort. The model"
echo "      and the projection must see the SAME variant set, so the"
echo "      projectable fit runs on the unpruned panel (on real data you"
echo "      would subset the new cohort to the store's kept sites and"
echo "      fit/project on that store instead) =="
$RUN pcoa --device "$DEVICE" --source plink --path "$OUT/panel" --num-pc 4 \
    --save-model "$OUT/panel_model.npz" \
    --output-path "$OUT/panel_coords_full.tsv" | sed -n 1,2p
$RUN project --device "$DEVICE" --source plink --path "$OUT/newcohort" \
    --ref-source plink --ref-path "$OUT/panel" \
    --model "$OUT/panel_model.npz" \
    --output-path "$OUT/new_coords.tsv" | sed -n 1,2p

echo "== done; outputs in $OUT =="
ls "$OUT"
