#!/usr/bin/env bash
# Data-parallel training of the port on GPUS cards of this host, one process
# per card (the counterpart of tools/dist_train.sh):
#   dsl_tpu_torch/tools/dist_train.sh CONFIG GPUS [extra train args]
CONFIG=$1
GPUS=$2
PORT=${PORT:-29500}
PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH \
python -m torch.distributed.run --nproc_per_node="$GPUS" --master_port="$PORT" \
    -m dsl_tpu_torch.tools.train "$CONFIG" --launcher pytorch "${@:3}"
