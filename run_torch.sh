#!/bin/sh
# Launcher of the PyTorch/CUDA port's margipose CLI from the repo checkout
# (run.sh is the JAX package's). The CUDA kernels and the host-ops library
# are built at first use, into build/margipose_tpu_torch/.
#   ./run_torch.sh [--device cuda|cpu] {gui,eval,train,hyperparams,infer,serve} ...
set -e
cd "$(dirname "$0")"
exec python -m margipose_tpu_torch.bin "$@"
