"""Optimiser schedules: 1cycle, multistep, and simple SGD/RMSProp.

Counterpart of ``margipose_tpu/train/schedules.py`` (reference:
src/margipose/hyperparam_scheduler.py:6-42 and
src/margipose/train_helpers.py:57-78). The schedules are host functions of
the update counter; ``ScheduledOptimiser`` sets a ``torch.optim`` optimiser's
lr and momentum from them before each step, reading the counter *before*
the update, as the JAX package's optax schedules do, and for SGD also on the
device, where a CUDA graph of the update reads them.
"""

from __future__ import annotations

import numpy as np
import torch


def piecewise_interpolate_schedule(ts, values):
    """Linear interpolation through (t, value) milestones, matching
    ``np.interp`` / the reference HyperparameterScheduler.batch_step
    (reference: src/margipose/hyperparam_scheduler.py:37-42). The arithmetic
    is float32 in the order of ``jnp.interp``, which the JAX package uses:
    ``f[i-1] + ((x - t[i-1]) / (t[i] - t[i-1])) * (f[i] - f[i-1])``, the last
    product and sum rounded once, as XLA's fused multiply-add does (exact in
    float64 for float32 factors), and held at the end values outside the
    milestones. Near the end of 1cycle, where lr is a small difference of
    large values, a second rounding would move it by 1e-5 relative."""
    ts = np.asarray(ts, dtype=np.float32)
    values = np.asarray(values, dtype=np.float32)

    def schedule(count):
        x = np.float32(count)
        if x < ts[0]:
            return float(values[0])
        if x > ts[-1]:
            return float(values[-1])
        i = min(max(int(np.searchsorted(ts, x, side='right')), 1), len(ts) - 1)
        dx = ts[i] - ts[i - 1]
        if abs(dx) <= np.spacing(np.finfo(np.float32).eps):
            return float(values[i - 1])
        frac = (x - ts[i - 1]) / dx
        df = values[i] - values[i - 1]
        return float(np.float32(np.float64(frac) * np.float64(df) + np.float64(values[i - 1])))

    return schedule


def onecycle_schedules(max_iters, lr_max, momentum=0.9):
    """The reference 1cycle policy (reference:
    src/margipose/hyperparam_scheduler.py:6-21): lr ramps
    lr_max/10 -> lr_max -> lr_max/10 -> lr_max/1e4 at t=[1, 0.45T, 0.9T, T];
    momentum 0.9 -> 0.85 -> 0.9.

    The reference increments its counter *before* the first batch, so its
    step-1 value applies to our count=0: the milestones are shifted by 1.
    """
    lr_min = lr_max * 1e-1
    lr_nihil = lr_min * 1e-3
    t3 = max_iters
    t2 = 0.9 * t3
    t1 = t2 / 2
    m_max = momentum
    m_min = min(m_max, 0.85)
    ts = [t - 1 for t in [1, t1, t2, t3]]
    lr = piecewise_interpolate_schedule(ts, [lr_min, lr_max, lr_min, lr_nihil])
    mom = piecewise_interpolate_schedule(ts, [m_max, m_min, m_max, m_max])
    return lr, mom


def multistep_schedule(lr, milestones, gamma, steps_per_epoch):
    """Epoch-milestone step decay (torch MultiStepLR semantics), stepped as
    optax's ``piecewise_constant_schedule``: the scale applies from the
    boundary count on."""
    boundaries = {int(m * steps_per_epoch): gamma for m in milestones}

    def schedule(count):
        value = lr
        for threshold, scale in sorted(boundaries.items()):
            if count >= threshold:
                value *= scale
        return float(np.float32(value))

    return schedule


def schedule_values(algorithm: str, lr: float, step: int, max_iters: int = None,
                    milestones=None, gamma=None, steps_per_epoch: int = None):
    """(lr, momentum) the optimiser applies at update ``step``: what the epoch
    meters record, and what ``ScheduledOptimiser`` sets before each step
    (reference: src/margipose/hyperparam_scheduler.py:24-42)."""
    if algorithm == '1cycle':
        lr_sched, mom_sched = onecycle_schedules(max_iters, lr_max=lr, momentum=0.9)
        return lr_sched(step), mom_sched(step)
    if algorithm == 'sgd_simple':
        return float(lr), 0.0
    if algorithm in ('sgd', 'nesterov', 'rmsprop'):
        sched = multistep_schedule(lr, milestones, gamma, steps_per_epoch)
        return sched(step), (0.8 if algorithm == 'nesterov' else 0.0)
    raise ValueError(f'unrecognised optimisation algorithm: {algorithm}')


class ScheduledOptimiser:
    """A ``torch.optim`` optimiser driven per step by a schedule.

    ``step()`` writes ``schedule(count)`` into every group's lr and momentum
    (``set_schedule``) and then updates the parameters in place
    (``update``); ``count`` is the number of updates made so far.
    ``state_dict`` holds the counter with the optimiser's buffers, so a
    restored run continues the schedule where it stopped.

    For ``torch.optim.SGD`` (``graphable``) ``set_schedule`` also fills two
    0-d float32 tensors on the parameters' device with lr and momentum, and
    ``update`` is torch's SGD written in ``torch._foreach_*`` ops that read
    them: it launches no host-valued kernel, so a CUDA graph of it replays
    each step's values (``train/steps.make_train_step``). The momentum
    buffers stay in ``optimiser.state[p]['momentum_buffer']``. Other
    optimisers take the host values through their own ``step()``.
    ``generation`` counts the ``load_state_dict`` calls, which replace the
    buffers a graph would have captured."""

    def __init__(self, optimiser: torch.optim.Optimizer, schedule):
        self.optimiser = optimiser
        self.schedule = schedule
        self.count = 0
        self.generation = 0
        self._values = None  # (lr, momentum) on the parameters' device

    @property
    def graphable(self) -> bool:
        return (type(self.optimiser) is torch.optim.SGD
                and not any(g['maximize'] for g in self.optimiser.param_groups))

    def graph_key(self):
        """What a graph of ``update`` depends on beyond the values of tensors:
        the buffers' generation and whether update ``count`` keeps momentum;
        None where it cannot be captured (not ``graphable``)."""
        if not self.graphable:
            return None
        return self.generation, self.schedule(self.count)[1] != 0

    def zero_grad(self):
        self.optimiser.zero_grad(set_to_none=True)

    def set_schedule(self):
        """lr and momentum of update ``count`` into the groups, and for a
        ``graphable`` optimiser into its two device tensors (two fills, no
        read-back)."""
        lr, momentum = self.schedule(self.count)
        for group in self.optimiser.param_groups:
            group['lr'] = lr
            group['momentum'] = momentum
        if self.graphable:
            if self._values is None:
                device = self.optimiser.param_groups[0]['params'][0].device
                self._values = (torch.zeros((), device=device), torch.zeros((), device=device))
            self._values[0].fill_(lr)
            self._values[1].fill_(momentum)

    @torch.no_grad()
    def update(self):
        """The update with the values ``set_schedule`` wrote. For SGD,
        torch's arithmetic (weight decay into the gradient; buf = m buf +
        (1 - dampening) g, a clone of g on the first update; Nesterov's g + m
        buf; p -= lr d) with lr and momentum read on the device; whether
        momentum is kept is the group's host value, as in torch."""
        if not self.graphable:
            self.optimiser.step()
            return
        lr, momentum = self._values
        state = self.optimiser.state
        for group in self.optimiser.param_groups:
            params = [p for p in group['params'] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group['weight_decay'] != 0:
                grads = torch._foreach_add(grads, params, alpha=group['weight_decay'])
            if group['momentum'] != 0:
                bufs = [state[p].get('momentum_buffer') for p in params]
                if all(b is not None for b in bufs):
                    torch._foreach_mul_(bufs, momentum)
                    torch._foreach_add_(bufs, grads, alpha=1 - group['dampening'])
                else:
                    for i, (p, g) in enumerate(zip(params, grads)):
                        if bufs[i] is None:
                            bufs[i] = state[p]['momentum_buffer'] = g.detach().clone()
                        else:
                            bufs[i].mul_(momentum).add_(g, alpha=1 - group['dampening'])
                if group['nesterov']:
                    grads = torch._foreach_add(grads, torch._foreach_mul(bufs, momentum))
                else:
                    grads = bufs
            torch._foreach_sub_(params, torch._foreach_mul(grads, lr))

    def step(self):
        self.set_schedule()
        self.update()
        self.count += 1

    def state_dict(self) -> dict:
        return {'count': self.count, 'optimiser': self.optimiser.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state['count'])
        self.optimiser.load_state_dict(state['optimiser'])
        self.generation += 1


def make_optimiser(algorithm: str, params, lr: float, max_iters: int = None,
                   milestones=None, gamma=None, steps_per_epoch: int = None
                   ) -> ScheduledOptimiser:
    """The optimiser for a named algorithm over ``params``, with the
    reference presets (reference: src/margipose/bin/train_3d.py:234-239,338-347):

      1cycle      momentum SGD, torch semantics (buf = m buf + g; p -= lr buf),
                  lr and momentum from ``onecycle_schedules``;
      sgd_simple  p -= lr g;
      sgd         the same under the multistep schedule;
      nesterov    Nesterov momentum 0.8 under the multistep schedule;
      rmsprop     alpha 0.99, eps 1e-8 outside the sqrt, multistep schedule.
    """
    def schedule(count):
        return schedule_values(algorithm, lr, count, max_iters=max_iters, milestones=milestones,
                               gamma=gamma, steps_per_epoch=steps_per_epoch)

    lr0, momentum0 = schedule(0)
    if algorithm in ('1cycle', 'sgd_simple', 'sgd'):
        optimiser = torch.optim.SGD(params, lr=lr0, momentum=momentum0)
    elif algorithm == 'nesterov':
        optimiser = torch.optim.SGD(params, lr=lr0, momentum=momentum0, nesterov=True)
    elif algorithm == 'rmsprop':
        optimiser = torch.optim.RMSprop(params, lr=lr0, alpha=0.99, eps=1e-8)
    else:
        raise ValueError(f'unrecognised optimisation algorithm: {algorithm}')
    return ScheduledOptimiser(optimiser, schedule)
