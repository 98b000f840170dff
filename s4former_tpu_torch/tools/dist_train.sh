#!/usr/bin/env bash
# Data-parallel training on one host, one process per card (the
# reference's tools/dist_train.sh interface):
#   s4former_tpu_torch/tools/dist_train.sh CONFIG NGPUS [train args ...]
# runs NGPUS ranks of s4former_tpu_torch.tools.train with --launcher env
# under torch.distributed.run; PORT (default 29500) is the rendezvous port.
CONFIG=$1
NGPUS=$2
PORT=${PORT:-29500}
shift 2
exec python -m torch.distributed.run --nproc_per_node "$NGPUS" \
    --master_port "$PORT" -m s4former_tpu_torch.tools.train "$CONFIG" \
    --launcher env "$@"
