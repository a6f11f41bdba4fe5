"""What every driver shares: finding a cell's files by name, the checkout's
cache directories, the clock of set-up, the port's model from the seeded
state dict, the guard against the JAX package, and the judgement of
``correct``."""

import importlib.util
import json
import os
import sys
import time
from os import path

ROOT = path.dirname(path.dirname(path.abspath(__file__)))
HERE = path.join(ROOT, 'benchmark')
# top-level module names the process that prints a result may not hold
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'margipose_tpu')


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def names(kind):
    """The names of ``benchmark/<kind>/``'s data files or modules."""
    out = []
    for f in sorted(os.listdir(path.join(HERE, kind))):
        stem, ext = path.splitext(f)
        if ext in ('.json', '.py') and not stem.startswith('_'):
            out.append(stem)
    return out


def load_json(kind, name):
    """``benchmark/<kind>/<name>.json``."""
    file = path.join(HERE, kind, f'{name}.json')
    if not path.isfile(file):
        raise SystemExit(f'benchmark: no {kind[:-1]} named {name!r} ({file})')
    with open(file) as f:
        return json.load(f)


def load_module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module; the name may hold dots."""
    file = path.join(HERE, kind, f'{name}.py')
    if not path.isfile(file):
        raise SystemExit(f'benchmark: no {kind[:-1]} named {name!r} ({file})')
    spec = importlib.util.spec_from_file_location(f'benchmark.{kind}.{name}', file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def spec():
    with open(path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def cell_metrics(cell, kind):
    """``BENCHMARK.json``'s ``kind`` ('end_to_end' or 'per_layer') metrics
    that ``cell`` reports: those that list it, and those that list no cell."""
    return [m for m in spec()[kind] if cell in m.get('workloads', [cell])]


def set_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into ``build/margipose_tpu_torch``)."""
    cache = path.join(ROOT, 'build', 'benchmark_cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = path.join(cache, 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = path.join(cache, 'triton')
    os.environ['USE_FLAX'] = '0'


def boot_clock():
    """Seconds since the machine booted: one clock for every process."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_age():
    """Seconds since this process started (the kernel's clock)."""
    with open('/proc/self/stat') as f:
        start_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
    return boot_clock() - start_ticks / os.sysconf('SC_CLK_TCK')


def log_marks(marks):
    """Log set-up's stages: (name, ``process_age()`` at its end) pairs."""
    log('set-up, seconds since the process started: '
        + ', '.join(f'{name} {t:.1f}' for name, t in marks))


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def port_model(config, state_dict, device):
    """The port's model of ``config`` on ``device`` in eval mode, its weights
    the seeded reference-format ``state_dict`` (``load_state_dict(strict=True)``,
    the port's weights bridge)."""
    import torch

    from margipose_tpu_torch.models import create_model

    with torch.device('meta'):
        model = create_model(config['model_desc'])
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def judge(readings, limits):
    """(correct, checks): every reading at or under its limit; a reading
    without a limit, or a limit without a reading, fails."""
    checks = {}
    correct = True
    for name in sorted(set(readings) | set(limits)):
        value, limit = readings.get(name), limits.get(name)
        checks[name] = {'value': value, 'limit': limit}
        if value is None or limit is None or not value <= limit:
            correct = False
    return correct, checks


def device_record(device_count, memory_peak_bytes):
    import torch

    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': device_count,
            'memory_peak_bytes': int(memory_peak_bytes)}
