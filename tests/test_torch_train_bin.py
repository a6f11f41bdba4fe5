"""The port's train bin end to end on the CPU.

``margipose_tpu_torch.bin.train_3d.main --device cpu`` trains MargiPose
(inceptionv4, 1 stage, 64 px) on ``synthetic-16`` at batch 2, two epochs of
two steps with a validation pass, and writes ``metrics.jsonl`` and a
``model-latest`` train-state directory, which the port's eval bin reads.
The crash-safe save and the background save's error path are held to what
``margipose_tpu/train/checkpoint.py`` promises. Seeded runs repeat bit for
bit (``test_torch_train_bin_repeat.py``) and a resumed run equals an
uninterrupted one (``test_torch_train_bin_resume.py``): each file trains
its own first run, so that under ``--dist loadfile`` no one file holds the
suite's wall time.
"""

import json
import os

import numpy as np
import pytest
import torch

import margipose_tpu_torch.bin.eval_3d as eval_3d
import margipose_tpu_torch.bin.train_3d as train_3d
from margipose_tpu_torch.checkpoint import load_model
from margipose_tpu_torch.train import checkpoint as ckpt

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

DESC = "model_desc={'settings': {'n_stages': 1, 'input_size': 64}}"


def _argv(out_dir, *extra, seed=3, experiment_id='run'):
    return ['--device', 'cpu', 'with', 'margipose_model', 'synthetic', DESC,
            "train_datasets=['synthetic-16']", "val_datasets=['synthetic-4@1']",
            'epochs=2', 'batch_size=2', 'train_examples=4', 'val_examples=4',
            'num_workers=0', 'metrics_every=1', f'seed={seed}', f'out_dir={out_dir}',
            f'experiment_id={experiment_id}', *extra]


def _final_state(out_dir, experiment_id='run'):
    return ckpt.load_payload(os.path.join(out_dir, experiment_id, 'model-latest'))


def _assert_states_equal(a, b):
    assert a['step'] == b['step']
    assert a['model'].keys() == b['model'].keys()
    for key in a['model']:
        assert torch.equal(a['model'][key], b['model'][key]), key
    assert a['optimiser']['count'] == b['optimiser']['count']
    for i, buf in a['optimiser']['optimiser']['state'].items():
        assert torch.equal(buf['momentum_buffer'],
                           b['optimiser']['optimiser']['state'][i]['momentum_buffer']), i


def train_first_run(tmp_path_factory):
    """The run the module fixtures share: (out_dir, result)."""
    out = str(tmp_path_factory.mktemp('train'))
    return out, train_3d.main(_argv(out))


@pytest.fixture(scope='module')
def first_run(tmp_path_factory):
    return train_first_run(tmp_path_factory)


def test_train_bin_writes_metrics_and_a_checkpoint_eval_reads(first_run):
    out, result = first_run
    run_dir = os.path.join(out, 'run')
    assert result['step'] == 4 and result['experiment_id'] == 'run'
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    assert [r['epoch'] for r in records] == [0, 1]
    for r in records:
        for key in ('train_loss', 'val_loss', 'val_mpjpe', 'lr', 'momentum', 'data_load_time'):
            assert np.isfinite(r[key]), key
    meta = ckpt.load_meta(os.path.join(run_dir, 'model-latest'))
    assert meta['epoch'] == 2 and meta['train_datasets'] == ['synthetic-16']
    assert sorted(os.listdir(os.path.join(run_dir, 'model-latest'))) == ['meta.json', 'state']

    model, desc = load_model(os.path.join(run_dir, 'model-latest'), 'cpu')
    assert desc['settings']['n_stages'] == 1 and not model.training
    rows, stats = eval_3d.main(['--model', os.path.join(run_dir, 'model-latest'),
                                '--dataset', 'synthetic-4', '--batch-size', '2',
                                '--device', 'cpu'])
    assert len(rows['mpjpe']) == 4 and np.isfinite(stats['mean_loss'])


def test_weights_warm_start_the_model_only(first_run, tmp_path, monkeypatch):
    out, _ = first_run
    latest = os.path.join(out, 'run', 'model-latest')
    seen = {}

    def capture(cfg, state, *args, **kwargs):
        seen['model'] = {k: v.clone() for k, v in state.model.state_dict().items()}
        seen['step'], seen['count'] = state.step, state.optimiser.count
        raise KeyboardInterrupt

    monkeypatch.setattr(train_3d, 'do_training_pass', capture)
    with pytest.raises(KeyboardInterrupt):
        train_3d.main(_argv(str(tmp_path), f'weights={latest}'))
    saved = ckpt.load_payload(latest)['model']
    assert seen['step'] == 0 and seen['count'] == 0  # a fresh optimiser and schedule
    for key, value in saved.items():
        assert torch.equal(seen['model'][key], value), key


def _tiny_state(seed):
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState

    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 3), torch.nn.BatchNorm2d(3))
    state = TrainState(model, make_optimiser('1cycle', model.parameters(), 0.1, max_iters=4))
    model(torch.randn(2, 2, 5, 5)).sum().backward()
    state.optimiser.step()
    state.step = 1
    return state


def test_an_interrupted_save_falls_back_to_state_old(tmp_path, monkeypatch):
    ckpt_dir = str(tmp_path / 'model-latest')
    first, second = _tiny_state(0), _tiny_state(1)
    ckpt.save_checkpoint(ckpt_dir, first, {'type': 'test'})
    real_rename = os.rename

    def die_before_the_swap(src, dst):
        if src.endswith('state.next'):
            raise OSError('killed mid-save')
        real_rename(src, dst)

    monkeypatch.setattr(os, 'rename', die_before_the_swap)
    with pytest.raises(OSError, match='killed mid-save'):
        ckpt.save_checkpoint(ckpt_dir, second, {'type': 'test'})
    monkeypatch.setattr(os, 'rename', real_rename)
    assert sorted(os.listdir(ckpt_dir)) == ['meta.json', 'state.next', 'state.old']

    restored = _tiny_state(2)
    ckpt.restore_checkpoint(ckpt_dir, restored)
    for key, value in first.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[key], value), key
    # the next save cleans up after the interrupted one
    ckpt.save_checkpoint(ckpt_dir, second, {'type': 'test'})
    assert sorted(os.listdir(ckpt_dir)) == ['meta.json', 'state']


def test_a_background_save_failure_reraises(tmp_path, capsys):
    blocker = tmp_path / 'not-a-directory'
    blocker.write_text('')
    thread = ckpt.save_checkpoint(str(blocker), _tiny_state(0), {}, background=True)
    with pytest.raises(OSError):
        thread.join()
    # at the end of a run: the save failure is the error
    thread = ckpt.save_checkpoint(str(blocker), _tiny_state(0), {}, background=True)
    with pytest.raises(OSError):
        train_3d._join_final_save(thread, in_flight=False)
    # with a training error propagating, the save failure is printed, not raised
    thread = ckpt.save_checkpoint(str(blocker), _tiny_state(0), {}, background=True)
    train_3d._join_final_save(thread, in_flight=True)
    assert 'background checkpoint save failed' in capsys.readouterr().err


def test_device_defaults_to_cuda_and_raises_without_a_card(tmp_path, monkeypatch):
    args, rest = train_3d.parse_args(['with', 'quick'])
    assert args.device == 'cuda' and rest == ['with', 'quick']
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='is_available'):
        train_3d.main(_argv(str(tmp_path))[2:])


def test_bf16_and_uint8_shipping_train_a_step(first_run, tmp_path, capsys):
    """precision='bfloat16' (autocast on the CPU) with ship='uint8' trains:
    finite losses, float32 weights, a checkpoint. The defaults resolve as
    the JAX bin's do: uint8 shipping, and float32 on the CPU."""
    out, _ = first_run
    with open(os.path.join(out, 'run', 'config.json')) as f:
        config = json.load(f)
    assert (config['precision'], config['ship']) == ('float32', 'uint8')
    assert train_3d.ex.parse(['with', 'margipose_model'])['precision'] is None
    result = train_3d.main(_argv(str(tmp_path), "precision='bfloat16'", "ship='uint8'",
                                 'epochs=1'))
    assert 'Precision: bfloat16; input upload: uint8' in capsys.readouterr().out
    assert result['step'] == 2 and np.isfinite(result['train_loss'])
    state = _final_state(str(tmp_path))
    assert all(v.dtype == torch.float32 for k, v in state['model'].items()
               if not k.endswith('num_batches_tracked'))


def test_uint8_shipping_trains_as_float32_does(first_run, tmp_path):
    """uint8 shipping (the default, as in the first run) is lossless up to
    the renormalisation's last ulp: the same run with ship='float32' ends
    with the same loss, to float32 noise."""
    _, uint8_result = first_run
    result = train_3d.main(_argv(str(tmp_path), "ship='float32'"))
    np.testing.assert_allclose(result['train_loss'], uint8_result['train_loss'], rtol=1e-4)


@pytest.mark.parametrize('override', ["precision='float16'", "ship='int8'"])
def test_unknown_precision_or_ship_raises(tmp_path, override):
    with pytest.raises(ValueError):
        train_3d.main(_argv(str(tmp_path), override))
    assert not os.listdir(tmp_path)

