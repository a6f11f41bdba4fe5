"""The 1cycle momentum-SGD step, in plain float32 PyTorch.

The reference policy (src/margipose/hyperparam_scheduler.py:6-42): the
learning rate goes lr_max/10 -> lr_max -> lr_max/10 -> lr_max/1e4 and the
momentum 0.9 -> 0.85 -> 0.9 at iterations 1, 0.45T, 0.9T and T, linearly in
between, counted from 1 before the first batch. The update is torch's
momentum SGD: buf = momentum * buf + grad (buf = grad at the first step),
p -= lr * buf.
"""

import numpy as np
import torch

from benchmark.reference.loss import masked_loss


def onecycle(count, max_iters, lr_max, momentum=0.9):
    """(lr, momentum) of update ``count`` (0 for the first)."""
    t = count + 1.0
    ts = [1.0, 0.45 * max_iters, 0.9 * max_iters, float(max_iters)]
    lr = np.interp(t, ts, [lr_max / 10, lr_max, lr_max / 10, lr_max / 1e4])
    mom = np.interp(t, ts, [momentum, min(momentum, 0.85), momentum, momentum])
    return float(lr), float(mom)


class OneCycleSGD:
    def __init__(self, params, lr_max, max_iters):
        self.params = list(params)
        self.lr_max, self.max_iters = lr_max, max_iters
        self.count = 0
        self.buffers = [None] * len(self.params)

    @torch.no_grad()
    def step(self):
        lr, mom = onecycle(self.count, self.max_iters, self.lr_max)
        for i, p in enumerate(self.params):
            if p.grad is None:
                continue
            buf = self.buffers[i]
            buf = p.grad.clone() if buf is None else buf.mul_(mom).add_(p.grad)
            self.buffers[i] = buf
            p.sub_(lr * buf)
        self.count += 1


def train_step(model, optimiser, batch):
    """One step of ``model`` in train mode on ``batch`` (input [B, 3, H, W],
    target, joint_mask, valid_depth): forward, masked loss, backward,
    update. Returns the loss and the coordinates."""
    model.train()
    for p in optimiser.params:
        p.grad = None
    xyz, hms = model(batch['input'])
    loss = masked_loss(hms, batch['target'], batch['joint_mask'], batch['valid_depth'])
    loss.backward()
    optimiser.step()
    return loss.detach(), xyz.detach()


def global_batch_step(model, optimiser, shards):
    """The step of a data-parallel group over its global batch: the ranks'
    rows ``shards`` put back together in rank order and stepped as one
    batch, so batch norm and the loss see every row."""
    batch = {k: torch.cat([s[k] for s in shards]) for k in shards[0]}
    return train_step(model, optimiser, batch)
