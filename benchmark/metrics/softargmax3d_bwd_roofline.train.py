"""softargmax3d_bwd_roofline.train: the volumetric soft-argmax's backward kernel's
share of its bytes bound in the traced train steps, %."""

from benchmark.costs_softargmax3d import roofline


def read(obs):
    return roofline(obs, 'bwd')
