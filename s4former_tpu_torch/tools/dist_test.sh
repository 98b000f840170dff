#!/usr/bin/env bash
# Evaluation over the cards of one host, one process per card (the
# reference's tools/dist_test.sh interface):
#   s4former_tpu_torch/tools/dist_test.sh CONFIG CHECKPOINT NGPUS [test args]
# runs NGPUS ranks of s4former_tpu_torch.tools.test with --launcher env
# under torch.distributed.run; PORT (default 29500) is the rendezvous port.
CONFIG=$1
CHECKPOINT=$2
NGPUS=$3
PORT=${PORT:-29500}
shift 3
exec python -m torch.distributed.run --nproc_per_node "$NGPUS" \
    --master_port "$PORT" -m s4former_tpu_torch.tools.test "$CONFIG" \
    "$CHECKPOINT" --launcher env "$@"
