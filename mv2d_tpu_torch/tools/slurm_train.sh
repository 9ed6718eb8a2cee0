#!/usr/bin/env bash
# Training of the port under SLURM: one srun task a GPU (the
# counterpart of the repository's tools/slurm_train.sh).
#
#   bash mv2d_tpu_torch/tools/slurm_train.sh <partition> <job-name> <config> [mv2d_tpu_torch.tools.train args...]
#
# GPUS tasks in all (default 8), GPUS_PER_NODE a node (default 8),
# CPUS_PER_TASK cores each (default 5), extra srun flags in SRUN_ARGS.  Each
# task takes RANK, WORLD_SIZE and LOCAL_RANK from SLURM_PROCID, SLURM_NTASKS
# and SLURM_LOCALID, and meets the others at the first host of the job's
# node list, port PORT (parallel.dist.init_distributed: NCCL on
# cuda:LOCAL_RANK), run by $PYTHON (default python3).
set -euo pipefail
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
shift 3
REPO=$(cd "$(dirname "$0")/../.." && pwd)
GPUS=${GPUS:-8}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
PORT=${PORT:-29500}
SRUN_ARGS=${SRUN_ARGS:-}
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" PORT

srun -p "$PARTITION" --job-name="$JOB_NAME" --gres=gpu:"$GPUS_PER_NODE" \
  --ntasks="$GPUS" --ntasks-per-node="$GPUS_PER_NODE" \
  --cpus-per-task="$CPUS_PER_TASK" --kill-on-bad-exit=1 ${SRUN_ARGS} \
  bash -c 'export RANK=$SLURM_PROCID WORLD_SIZE=$SLURM_NTASKS \
             LOCAL_RANK=$SLURM_LOCALID MASTER_PORT=$PORT \
             MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)
           exec "${PYTHON:-python3}" -m mv2d_tpu_torch.tools.train "$@"' _ "$CONFIG" "$@"
