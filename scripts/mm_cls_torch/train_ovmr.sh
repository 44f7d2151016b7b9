#!/bin/bash
# Train the OVMR visual token generator (stage 1).
# Usage: bash scripts/mm_cls_torch/train_ovmr.sh <dataset> <seed> <n_ctx> <device_id>
# The PyTorch/CUDA port's copy of scripts/mm_cls/train_ovmr.sh: the same arguments
# and output directories, run by python -m ovmr_tpu_torch.train on the CUDA
# card <device_id> (CUDA_VISIBLE_DEVICES), as the reference scripts do.
DATASET=$1
SEED=$2
N_CTX=$3

if [ -n "${4}" ]; then export CUDA_VISIBLE_DEVICES=${4}; fi

DATA=./data
TRAINER=MM_CLS_OP
CFG=vit_b16_c4_ep50_imagenet21k_pretrain
SHOTS=64

DIR=output_ovmr/base2new/train_base/${DATASET}/shots_${SHOTS}/${TRAINER}/${CFG}/seed${SEED}
if [ -d "$DIR" ]; then
    echo "Oops! The results exist at ${DIR} (so skip this job)"
else
    python -m ovmr_tpu_torch.train \
    --root ${DATA} \
    --seed ${SEED} \
    --trainer ${TRAINER} \
    --dataset-config-file configs/datasets/${DATASET}.yaml \
    --config-file configs/trainers/${TRAINER}/${CFG}.yaml \
    --output-dir ${DIR} \
    --n_ctx ${N_CTX} \
    DATASET.NUM_SHOTS ${SHOTS} \
    DATASET.SUBSAMPLE_CLASSES all
fi
