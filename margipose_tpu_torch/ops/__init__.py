from margipose_tpu_torch.ops.dsnt import (
    average_loss,
    dsnt,
    euclidean_losses,
    flat_softmax,
    js_reg_losses,
    make_gauss,
    normalized_linspace,
)
from margipose_tpu_torch.ops.dsnt_jsd import (
    dsnt_jsd_bwd,
    dsnt_jsd_bwd_plain,
    dsnt_jsd_fused,
    dsnt_jsd_plain,
)

__all__ = [
    "average_loss",
    "dsnt",
    "dsnt_jsd_bwd",
    "dsnt_jsd_bwd_plain",
    "dsnt_jsd_fused",
    "dsnt_jsd_plain",
    "euclidean_losses",
    "flat_softmax",
    "js_reg_losses",
    "make_gauss",
    "normalized_linspace",
]
