"""nccl_ms_per_step.ddp: device time in NCCL kernels on rank 0 per step."""

from benchmark.readers import collective_ms_per_step as read  # noqa: F401
