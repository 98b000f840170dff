#!/usr/bin/env bash
# Training under Slurm, one task per GPU (the reference's
# tools/slurm_train.sh interface):
#   s4former_tpu_torch/tools/slurm_train.sh PARTITION JOB CONFIG [train args]
# GPUS (default 4) tasks in all, GPUS_PER_NODE (default 4) a node,
# CPUS_PER_TASK (default 5); SRUN_ARGS is passed to srun. Each task runs
# s4former_tpu_torch.tools.train with --launcher slurm (the group's address
# from SLURM_STEP_NODELIST, its rank from SLURM_PROCID, its card from
# SLURM_LOCALID) and --auto-resume, as the JAX package's script does, so a
# requeued job resumes from its latest checkpoint.
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
shift 3
GPUS=${GPUS:-4}
GPUS_PER_NODE=${GPUS_PER_NODE:-4}
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
SRUN_ARGS=${SRUN_ARGS:-""}
srun -p "$PARTITION" --job-name="$JOB_NAME" --gres=gpu:"$GPUS_PER_NODE" \
    --ntasks="$GPUS" --ntasks-per-node="$GPUS_PER_NODE" \
    --cpus-per-task="$CPUS_PER_TASK" --kill-on-bad-exit=1 ${SRUN_ARGS} \
    python -u -m s4former_tpu_torch.tools.train "$CONFIG" \
    --launcher slurm --auto-resume "$@"
