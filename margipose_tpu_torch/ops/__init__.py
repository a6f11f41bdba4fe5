from margipose_tpu_torch.ops._build import launch_counts, zero_launch_counts
from margipose_tpu_torch.ops.dsnt import (
    average_loss,
    coord_expectation,
    coord_variance,
    dsnt,
    euclidean_losses,
    flat_softmax,
    js_reg_losses,
    kl_reg_losses,
    make_gauss,
    normalized_linspace,
)
from margipose_tpu_torch.ops.dsnt_jsd import (
    dsnt_jsd_bwd,
    dsnt_jsd_bwd_plain,
    dsnt_jsd_fused,
    dsnt_jsd_fwd,
    dsnt_jsd_fwd_plain,
    dsnt_jsd_grouped,
    dsnt_jsd_plain,
)

__all__ = [
    "average_loss",
    "coord_expectation",
    "coord_variance",
    "dsnt",
    "dsnt_jsd_bwd",
    "dsnt_jsd_bwd_plain",
    "dsnt_jsd_fused",
    "dsnt_jsd_fwd",
    "dsnt_jsd_fwd_plain",
    "dsnt_jsd_grouped",
    "dsnt_jsd_plain",
    "euclidean_losses",
    "flat_softmax",
    "js_reg_losses",
    "kl_reg_losses",
    "launch_counts",
    "make_gauss",
    "normalized_linspace",
    "zero_launch_counts",
]
