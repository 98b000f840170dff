#!/usr/bin/env bash
# Evaluation under Slurm, one task per GPU (the reference's
# tools/slurm_test.sh interface):
#   s4former_tpu_torch/tools/slurm_test.sh PARTITION JOB CONFIG CHECKPOINT \
#       [test args]
# GPUS (default 4) tasks in all, GPUS_PER_NODE (default 4) a node,
# CPUS_PER_TASK (default 5); SRUN_ARGS is passed to srun. Each task runs
# s4former_tpu_torch.tools.test with --launcher slurm.
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
CHECKPOINT=$4
shift 4
GPUS=${GPUS:-4}
GPUS_PER_NODE=${GPUS_PER_NODE:-4}
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
SRUN_ARGS=${SRUN_ARGS:-""}
srun -p "$PARTITION" --job-name="$JOB_NAME" --gres=gpu:"$GPUS_PER_NODE" \
    --ntasks="$GPUS" --ntasks-per-node="$GPUS_PER_NODE" \
    --cpus-per-task="$CPUS_PER_TASK" --kill-on-bad-exit=1 ${SRUN_ARGS} \
    python -u -m s4former_tpu_torch.tools.test "$CONFIG" "$CHECKPOINT" \
    --launcher slurm "$@"
