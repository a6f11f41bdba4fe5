"""dsnt_jsd_bwd_us.train: the loss-head backward kernel's mean device time a
launch in the traced train steps, us. (Not a roofline share: in the train
step it reads heatmaps the softmax's backward has just left in the 50 MB L2
and runs under the HBM bytes bound, 102% of it in the first trace.)"""

from benchmark.readers import kernel_seconds


def read(obs):
    launches, seconds = kernel_seconds(obs, 'dsnt_jsd_bwd_kernel')
    return 1e6 * seconds / launches if launches else None
