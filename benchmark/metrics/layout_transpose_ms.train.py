"""layout_transpose_ms.train: device ms a traced train step in cuDNN's
layout transposes, the kernels whose name holds 'nchwToNhwc' or
'nhwcToNchw': what the step pays to hand NCHW tensors to cuDNN's NHWC
convolutions and take their outputs back. 0 in a traced step that ran
none."""

from benchmark.readers import kernel_seconds

MARKERS = ('nchwToNhwc', 'nhwcToNchw')


def read(obs):
    steps = (obs.get('trace') or {}).get('steps')
    if not steps:
        return None
    return 1e3 * sum(kernel_seconds(obs, m)[1] for m in MARKERS) / steps
