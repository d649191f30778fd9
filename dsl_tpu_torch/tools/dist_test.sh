#!/usr/bin/env bash
# Data-parallel evaluation of the port on GPUS cards of this host, one
# process per card (the counterpart of tools/dist_test.sh):
#   dsl_tpu_torch/tools/dist_test.sh CONFIG CHECKPOINT GPUS [extra test args]
CONFIG=$1
CHECKPOINT=$2
GPUS=$3
PORT=${PORT:-29500}
PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH \
python -m torch.distributed.run --nproc_per_node="$GPUS" --master_port="$PORT" \
    -m dsl_tpu_torch.tools.test "$CONFIG" "$CHECKPOINT" --launcher pytorch "${@:4}"
