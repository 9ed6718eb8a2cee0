#!/usr/bin/env bash
# Data-parallel evaluation of the port on N GPUs: one process a GPU under
# torchrun (the counterpart of the repository's tools/dist_test.sh).
#
#   bash mv2d_tpu_torch/tools/dist_test.sh <config> [mv2d_tpu_torch.tools.test args...]
#
# GPUS processes on this node (default: every local GPU), NNODES nodes, this
# one NODE_RANK, the rendezvous at MASTER_ADDR:PORT.  Each process reads
# RANK / WORLD_SIZE / LOCAL_RANK (parallel.dist.init_distributed: NCCL on
# cuda:LOCAL_RANK; gloo with --device cpu, where GPUS must be given), run by
# $PYTHON (default python3).
set -euo pipefail
CONFIG=$1
shift
REPO=$(cd "$(dirname "$0")/../.." && pwd)
GPUS=${GPUS:-$(nvidia-smi -L 2>/dev/null | grep -c '^GPU' || true)}
GPUS=${GPUS:-1}
[[ "$GPUS" -gt 0 ]] || GPUS=1
NNODES=${NNODES:-1}
NODE_RANK=${NODE_RANK:-0}
MASTER_ADDR=${MASTER_ADDR:-127.0.0.1}
PORT=${PORT:-29500}

PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" exec "${PYTHON:-python3}" -m torch.distributed.run \
  --nnodes="$NNODES" --node_rank="$NODE_RANK" --master_addr="$MASTER_ADDR" \
  --master_port="$PORT" --nproc_per_node="$GPUS" \
  -m mv2d_tpu_torch.tools.test "$CONFIG" "$@"
