"""What the per-layer metric readers (``metrics/<name>.py``) share. A
reader takes the driver's observations and returns a number, or None where
the run holds nothing to read."""

from benchmark import costs


def mfu(obs):
    """The whole step's share of the card's peak, %: the reference's FLOPs
    per image (x3 a trained image) times the window's images, over the
    window's host time, over the peak at the cell's precision."""
    c = obs.get('costs')
    if not c or not obs.get('images'):
        return None
    return 100.0 * c['passes_per_image'] * c['flops_per_image'] * obs['images'] / (
        obs['window_s'] * c['peak_flops'])


def idle_share(obs):
    """The traced window's share with nothing running on the device, %."""
    t = obs.get('trace')
    if not t or t['window_s'] <= 0 or t['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])


def kernel_seconds(obs, marker):
    """(launches, seconds) of the traced kernels whose name holds ``marker``."""
    t = obs.get('trace')
    if not t:
        return 0, 0.0
    hits = [v for name, v in t['kernels'].items() if marker in name]
    return sum(h[0] for h in hits), sum(h[1] for h in hits)


def dsnt_jsd_roofline(obs, direction):
    """The loss-head kernel's share of its bytes bound, %: the least time its
    shapes' traffic takes at the card's bandwidth over its mean traced time a
    launch."""
    launches, seconds = kernel_seconds(obs, f'dsnt_jsd_{direction}_kernel')
    if not launches or seconds <= 0:
        return None
    c = obs['costs']
    hw = c['heatmap']
    nbytes = (costs.dsnt_jsd_fwd_bytes if direction == 'fwd' else costs.dsnt_jsd_bwd_bytes)(
        c['loss_head_rows'], hw, hw)
    return 100.0 * costs.bound_seconds(nbytes) / (seconds / launches)


def launches_per_step(obs):
    t = obs.get('trace')
    if not t or not t.get('steps') or not t['launches']:
        return None
    return t['launches'] / t['steps']


def collective_ms_per_step(obs):
    """Device time in the traced NCCL kernels a traced step, ms."""
    launches, seconds = kernel_seconds(obs, 'nccl')
    steps = obs['trace'].get('steps') if launches else None
    if not steps:
        return None
    return 1e3 * seconds / steps


def mean_ms(values):
    return 1e3 * sum(values) / len(values) if values else None
