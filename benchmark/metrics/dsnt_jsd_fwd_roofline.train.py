"""dsnt_jsd_fwd_roofline.train: the loss-head forward kernel's share of its bytes bound, %."""

from benchmark.readers import dsnt_jsd_roofline


def read(obs):
    return dsnt_jsd_roofline(obs, 'fwd')
