"""launches_per_step.train: kernels in the traced window per train step."""

from benchmark.readers import launches_per_step as read  # noqa: F401
