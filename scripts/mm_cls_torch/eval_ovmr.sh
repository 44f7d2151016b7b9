#!/bin/bash
# Evaluate OVMR classifier generation on a downstream dataset.
# Usage: bash scripts/mm_cls_torch/eval_ovmr.sh <dataset> <seed> <sub_classes> <n_ctx> <eval_mode> <eval_tau> <device_id>
# The PyTorch/CUDA port's copy of scripts/mm_cls/eval_ovmr.sh: the same arguments
# and output directories, run by python -m ovmr_tpu_torch.train on the CUDA
# card <device_id> (CUDA_VISIBLE_DEVICES), as the reference scripts do.
DATASET=$1
SEED=$2
SUB_CLASSES=$3
N_CTX=$4
EVAL_MODE=$5
EVAL_TAU=$6

if [ -n "${7}" ]; then export CUDA_VISIBLE_DEVICES=${7}; fi

DATA=./data
TRAINER=MM_CLS_OP
CFG=vit_b16_c4_ep50_imagenet21k_pretrain
SHOTS=16
LOADEP=30
SUB=${SUB_CLASSES}

COMMON_DIR=${DATASET}/shots_${SHOTS}/${TRAINER}/${CFG}/seed${SEED}
COMMON_DIR_train=imagenet_21k_P/shots_64/${TRAINER}/${CFG}/seed1
MODEL_DIR=output_ovmr/base2new/train_base/${COMMON_DIR_train}
DIR=output_ovmr/base2new/test_${SUB}_${EVAL_MODE}_tau${EVAL_TAU}/${COMMON_DIR}
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
    --model-dir ${MODEL_DIR} \
    --load-epoch ${LOADEP} \
    --eval_mode ${EVAL_MODE} \
    --eval_tau ${EVAL_TAU} \
    --n_ctx ${N_CTX} \
    --eval-only \
    DATASET.NUM_SHOTS ${SHOTS} \
    DATASET.SUBSAMPLE_CLASSES ${SUB}
fi
