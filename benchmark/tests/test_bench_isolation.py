"""What the harness may load, how it fails without a card, and that a new
cell is data alone."""

import ast
import json
import os
import shutil
import subprocess
import sys
from os import path

import pytest

from benchmark import common

REFERENCE = path.join(common.HERE, 'reference')
CELLS = [w['name'] for w in common.spec()['workloads']]
FILES = common.names('workloads')  # with the cells BENCHMARK.json does not list yet


def _top_level_imports(file):
    tree = ast.parse(open(file).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_references_import_nothing_of_the_port_or_jax():
    for f in sorted(os.listdir(REFERENCE)):
        if f.endswith('.py'):
            found = set(_top_level_imports(path.join(REFERENCE, f)))
            assert not found & {'margipose_tpu_torch', 'margipose_tpu', 'jax', 'jaxlib', 'flax'}, f


def test_references_load_nothing_of_the_port():
    code = ('import sys, benchmark.reference as r, benchmark.reference.margipose, '
            'benchmark.reference.chatterbox, benchmark.reference.loss, benchmark.reference.sgd, '
            'benchmark.reference.lowp, benchmark.reference.inputs\n'
            'print(sorted({m.split(".")[0] for m in sys.modules}))')
    out = subprocess.run([sys.executable, '-c', code], cwd=common.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert not set(json.loads(out.replace("'", '"'))) & {'margipose_tpu_torch', 'margipose_tpu',
                                                          'jax'}


@pytest.mark.parametrize('cell', FILES)
def test_a_cell_loads_neither_jax_nor_the_jax_package(cell):
    """Each cell's whole run at test size in a fresh process (the chip check
    skipped): the top-level names it leaves in sys.modules, compared whole."""
    code = f'''
import json, sys, torch
torch.set_num_threads(2)
from benchmark import common, run
from benchmark.tests.conftest import small_context
ctx = small_context({cell!r}, trace=True)
run.run_cell(ctx)
print(json.dumps(common.forbidden_modules()))
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
'''
    proc = subprocess.run([sys.executable, '-c', code], cwd=common.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    forbidden, loaded = (json.loads(x) for x in proc.stdout.strip().splitlines()[-2:])
    assert forbidden == []
    assert 'margipose_tpu' not in loaded
    if common.load_json('workloads', cell)['chips'] == 1:  # else the port runs in workers
        assert 'margipose_tpu_torch' in loaded


def test_no_card_no_result():
    """Without a CUDA device the command prints no result and exits non-zero."""
    proc = subprocess.run([sys.executable, '-m', 'benchmark.run', '--workload', CELLS[0],
                           '--seed', str(2**31 + 11), '--seconds', '1', '--trace', '0'],
                          cwd=common.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'CUDA device' in proc.stderr


def test_only_the_benchmark_and_its_spec_is_no_benchmark(tmp_path):
    """A checkout that holds only BENCHMARK.json and benchmark/ exits non-zero
    with no result: the port is missing."""
    shutil.copy(path.join(common.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(common.HERE, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    proc = subprocess.run([sys.executable, '-m', 'benchmark.run', '--workload', CELLS[0],
                           '--seed', '7', '--seconds', '1'], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=''))
    assert proc.returncode != 0 and proc.stdout.strip() == ''


def test_files_are_found_by_name():
    spec = common.spec()
    assert set(CELLS) <= set(common.names('workloads'))
    for w in spec['workloads']:
        cell = common.load_json('workloads', w['name'])
        assert (cell['config'], cell['traffic'], cell['chips']) == (w['config'], w['traffic'],
                                                                    w['chips'])
        common.load_json('configs', cell['config'])
        common.load_json('traffic', cell['traffic'])
        assert hasattr(common.load_module('drivers', cell['driver']), 'run')
    for c in spec['configs']:
        assert path.join(common.ROOT, c['file']) == path.join(common.HERE, 'configs',
                                                               f"{c['name']}.json")
    for m in spec['per_layer']:
        assert hasattr(common.load_module('metrics', m['name']), 'read')
        for cell in m['workloads']:
            assert m['moves'] in [e['name'] for e in common.cell_metrics(cell, 'end_to_end')]


def test_a_new_cell_is_data_alone(tmp_path):
    """A copy of the benchmark gains a cell by two new data files and its
    entries in BENCHMARK.json (the cell, an end-to-end metric, two per-layer
    metrics whose readers exist), and runs it: no file of the harness
    edited."""
    root = tmp_path / 'checkout'
    shutil.copytree(common.HERE, root / 'benchmark', ignore=shutil.ignore_patterns('__pycache__'))
    spec = common.spec()
    before = {p: open(p, 'rb').read() for p in map(str, (root / 'benchmark').rglob('*.py'))}
    name = 'margipose-train-bf16-b2'
    traffic = dict(common.load_json('traffic', 'train-b32'), batch=2)
    (root / 'benchmark' / 'traffic' / 'train-b2.json').write_text(json.dumps(traffic))
    cell = dict(common.load_json('workloads', 'margipose-train-bf16-b32'), name=name,
                traffic='train-b2')
    (root / 'benchmark' / 'workloads' / f'{name}.json').write_text(json.dumps(cell))
    spec['workloads'].append({'name': name, 'config': cell['config'], 'traffic': 'train-b2',
                              'chips': 1, 'why': 'a test cell'})
    spec['end_to_end'].append({'name': 'train_images_per_s', 'unit': 'images/s',
                               'better': 'higher', 'bound': 0.25, 'source': 'host_clock',
                               'workloads': [name]})
    for metric in ('mfu.train', 'launches_per_step.train'):
        spec['per_layer'].append({'name': metric, 'unit': '%', 'better': 'higher',
                                  'source': 'host_clock', 'layer': 'train step',
                                  'moves': 'train_images_per_s', 'workloads': [name]})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    os.symlink(path.join(common.ROOT, 'margipose_tpu_torch'), root / 'margipose_tpu_torch')
    code = f'''
import json, torch
torch.set_num_threads(2)
from benchmark import run
from benchmark.tests.conftest import small_context
for trace in (False, True):
    ctx = small_context({name!r}, trace=trace)
    ctx.traffic['batch'] = 2
    print(json.dumps(run.run_cell(ctx)['metrics']))
'''
    proc = subprocess.run([sys.executable, '-c', code], cwd=root, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    e2e, layers = (json.loads(x) for x in proc.stdout.strip().splitlines()[-2:])
    assert set(e2e) == {'setup_s', 'train_images_per_s'}
    assert set(layers) == {'mfu.train'}  # a CPU trace holds no kernel launches
    assert before == {p: open(p, 'rb').read() for p in before}
