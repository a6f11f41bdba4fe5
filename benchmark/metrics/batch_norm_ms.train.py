"""batch_norm_ms.train: device ms a traced train step in kernels whose name
holds 'batch_norm': the port's train-mode kernels (batch_norm_train_*), or
ATen's (statistics, transform, backward) where the program still runs
those. ATen's path also ran a clone and four elementwise kernels a layer
for the running variance, which this leaves out. Not a roofline share: a
batch norm reads the convolution output that may still sit in the 50 MB
L2."""

from benchmark.readers import kernel_seconds


def read(obs):
    launches, seconds = kernel_seconds(obs, 'batch_norm')
    steps = obs['trace'].get('steps') if launches else None
    if not steps:
        return None
    return 1e3 * seconds / steps
