"""The integral model (Integral Human Pose Regression, arXiv:1711.08229) on
the port's normal path, on the CPU.

``models/integral.IntegralPoseModel`` against the plain float32 reference
``benchmark/reference/integral.py`` from one seeded state dict at a small
size (64 px, D = 8, batch 2): the forward's coordinates, the L1 loss on a
2D/3D-mixed batch and every parameter's gradient. The soft-argmax's
closed-form backward (``ops/softargmax3d.softargmax3d_bwd_plain``, what the
CUDA backward kernel computes) against autograd. The factory at the
published widths and a strict load of the reference's keys. The train and
eval steps take the model's own loss, and MargiPose's and Chatterbox's are
the ``margipose_masked_loss`` they were, bit for bit. The train bin trains
an integral description, and the eval bin, ``infer_single`` and the serve
runner run its checkpoint. The kernels against their plain versions need
the card (``-m cuda``).
"""

import copy
import os
import sys

import numpy as np
import PIL.Image
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # the benchmark's plain reference lives at the root

import margipose_tpu_torch.bin.eval_3d as eval_3d  # noqa: E402
import margipose_tpu_torch.bin.train_3d as train_3d  # noqa: E402
from benchmark import weights  # noqa: E402
from benchmark.reference import integral as reference  # noqa: E402
from margipose_tpu_torch.bin import infer_single, serve  # noqa: E402
from margipose_tpu_torch.checkpoint import load_model  # noqa: E402
from margipose_tpu_torch.data.specs import device_input  # noqa: E402
from margipose_tpu_torch.models import Default_Integral_Desc, create_model  # noqa: E402
from margipose_tpu_torch.models.integral import IntegralPoseModel  # noqa: E402
from margipose_tpu_torch.models.margipose import margipose_masked_loss  # noqa: E402
from margipose_tpu_torch.ops import softargmax3d as sa  # noqa: E402
from margipose_tpu_torch.train.schedules import make_optimiser  # noqa: E402
from margipose_tpu_torch.train.steps import (  # noqa: E402
    TrainState,
    make_eval_step,
    make_train_step,
)

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

DEPTH, SIZE = 8, 64
SMALL = {'model_desc': {'type': 'integral', 'version': '1.0.0',
                        'settings': {'depth_dim': DEPTH, 'input_size': SIZE}},
         'reference': {'module': 'integral', 'class': 'TIntegralPose',
                       'kwargs': {'n_joints': 17, 'depth_dim': DEPTH}},
         'input_size': SIZE, 'scale_down': {'head.features.9.weight': 4.0}}
CPU = torch.device('cpu')


def _pair(seed=3):
    """(reference, port) from one seeded reference-format state dict."""
    ref, state_dict = weights.seeded_reference(SMALL, seed, CPU)
    with torch.device('meta'):
        port = create_model(SMALL['model_desc'])
    port = port.to_empty(device=CPU)
    port.load_state_dict({k: v.clone() for k, v in state_dict.items()}, strict=True)
    return ref, port


def _batch(seed=1, n=2):
    """A mixed batch: row 0 3D, row 1 2D with joints 3-6 masked out."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(n, 17)
    mask[1, 3:7] = 0
    return {'input': torch.randn(n, 3, SIZE, SIZE, generator=g),
            'target': torch.empty(n, 17, 3).uniform_(-0.9, 0.9, generator=g),
            'joint_mask': mask, 'valid_depth': torch.tensor([1, 0][:n])}


def test_forward_loss_and_gradients_match_the_reference():
    ref, port = _pair()
    batch = _batch()
    r_xyz, r_logits = ref.train()(batch['input'])
    p_xyz, p_out = port.train()(batch['input'])
    r_loss = reference.masked_l1_loss(r_xyz, batch['target'], batch['joint_mask'],
                                      batch['valid_depth'])
    p_loss = port.masked_loss(p_out, batch['target'], batch['joint_mask'], batch['valid_depth'])
    r_loss.backward()
    p_loss.backward()
    assert p_xyz.shape == (2, 17, 3) and p_out.logits.shape == (2, 17 * DEPTH, 16, 16)
    assert torch.allclose(p_out.logits, r_logits, atol=1e-4)
    assert torch.allclose(p_xyz, r_xyz, atol=1e-5)
    # the 2D row's z stays out of the loss, the masked joints out of the mean
    assert float(p_xyz.detach().abs().max()) > 0.01
    assert torch.allclose(p_loss, r_loss, rtol=1e-5)
    r_params = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        want = r_params[name].grad
        assert torch.allclose(p.grad, want, rtol=1e-3, atol=1e-5 * float(want.abs().max())), name


def test_the_loss_is_the_l1_of_the_kept_coordinates():
    _, port = _pair()
    batch = _batch()
    with torch.no_grad():
        xyz, out = port.eval()(batch['input'])
    err = (xyz - batch['target']).abs()
    per_joint = torch.stack([err[0].sum(-1), err[1, :, :2].sum(-1)])
    want = (per_joint * batch['joint_mask']).sum() / batch['joint_mask'].sum()
    loss = port.masked_loss(out, batch['target'], batch['joint_mask'], batch['valid_depth'])
    assert torch.allclose(loss, want, rtol=1e-6)
    assert float(port.masked_loss(out, batch['target'], torch.zeros(2, 17),
                                  batch['valid_depth'])) == 0.0


@pytest.mark.parametrize('shape', [(2, 3, 4, 8, 16), (1, 17, 8, 16, 16), (2, 2, 3, 5, 8)])
def test_closed_form_backward_matches_autograd(shape):
    b, j, d, h, w = shape
    g = torch.Generator().manual_seed(sum(shape))
    logits = (3 * torch.randn(b, j * d, h, w, generator=g)).requires_grad_()
    grad = torch.randn(b, j, 3, generator=g)
    xyz = sa.softargmax3d_plain(logits, d)
    xyz.backward(grad)
    got_xyz, stats = sa.softargmax3d_fwd_plain(logits.detach(), d)
    got = sa.softargmax3d_bwd_plain(logits.detach(), d, got_xyz, stats, grad)
    assert torch.allclose(got_xyz, xyz, atol=1e-6)
    assert torch.allclose(got, logits.grad, atol=1e-6 * float(logits.grad.abs().max()) + 1e-9)
    # the CPU's wrapper is the plain version
    assert torch.equal(sa.softargmax3d(logits.detach(), d), sa.softargmax3d_plain(logits, d))


def test_the_coordinates_are_the_voxel_centres_expectations():
    """A volume with all its mass in one voxel gives that voxel's centre
    (2i + 1)/n - 1 on each axis; a flat one gives 0."""
    d, h, w = 4, 8, 16
    logits = torch.full((1, 2 * d, h, w), -1e4)
    logits[0, 2, 5, 11] = 0.0  # joint 0: depth 2, row 5, column 11
    logits[0, d:] = 0.0  # joint 1: flat
    xyz = sa.softargmax3d(logits, d)
    assert torch.allclose(xyz[0, 0], torch.tensor([23 / 16 - 1, 11 / 8 - 1, 5 / 4 - 1]))
    assert torch.allclose(xyz[0, 1], torch.zeros(3), atol=1e-6)


def test_the_factory_builds_the_published_widths():
    model = create_model(Default_Integral_Desc)
    assert isinstance(model, IntegralPoseModel)
    assert sum(p.numel() for p in model.parameters()) == 34274944
    deconvs = [m for m in model.head.modules() if isinstance(m, torch.nn.ConvTranspose2d)]
    assert [(m.out_channels, m.kernel_size, m.stride, m.padding) for m in deconvs] == [
        (256, (4, 4), (2, 2), (1, 1))] * 3
    assert model.head.features[9].out_channels == 17 * 64 and model.depth_dim == 64
    blocks = [len(getattr(model.backbone, f'layer{i}')) for i in range(1, 5)]
    assert blocks == [3, 4, 6, 3]
    keys = model.state_dict().keys()
    assert {'backbone.layer4.2.bn3.running_var', 'backbone.layer3.0.downsample.0.weight',
            'backbone.layer4.0.downsample.1.weight', 'head.features.9.bias'} <= set(keys)
    with torch.device('meta'):
        ref = reference.TIntegralPose()
    assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    with torch.no_grad():
        xyz, out = model(torch.randn(1, 3, 64, 64))  # 64 px: heatmaps of 16x16
    assert xyz.shape == (1, 17, 3) and out.logits.shape == (1, 17 * 64, 16, 16)
    with pytest.raises(ValueError):
        create_model({'type': 'integral', 'version': '2.0.0', 'settings': {}})


def test_the_reference_state_dict_loads_strictly():
    ref, port = _pair()
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in ref.state_dict().items())
    bad = dict(ref.state_dict(), surplus=torch.zeros(1))
    with pytest.raises(RuntimeError):
        copy.deepcopy(port).load_state_dict(bad, strict=True)


def _margipose():
    desc = {'type': 'margipose', 'version': '6.0.1',
            'settings': {'n_stages': 1, 'input_size': 64, 'pixelwise_loss': 'jsd'}}
    return create_model(desc, generator=torch.Generator().manual_seed(5)), 64, 2


def _chatterbox():
    desc = {'type': 'chatterbox', 'version': '1.3.0', 'settings': {'pixelwise_loss': 'jsd'}}
    return create_model(desc, generator=torch.Generator().manual_seed(5)), 256, 1


@pytest.mark.parametrize('make', [_margipose, _chatterbox], ids=['margipose', 'chatterbox'])
def test_marginal_models_losses_are_the_parents_bit_for_bit(make):
    """The steps' loss through the model's ``masked_loss`` equals
    ``margipose_masked_loss`` called as the steps called it before."""
    model, size, n = make()
    g = torch.Generator().manual_seed(2)
    batch = {'input': torch.randn(n, 3, size, size, generator=g),
             'target': torch.empty(n, 17, 3).uniform_(-0.9, 0.9, generator=g),
             'joint_mask': torch.ones(n, 17), 'valid_depth': torch.tensor([1, 0][:n])}
    with torch.no_grad():
        _, out = model.eval()(batch['input'])
        want = margipose_masked_loss(out, batch['target'], batch['joint_mask'],
                                     batch['valid_depth'], 'jsd')
    got = make_eval_step('jsd')(model, batch)['loss']
    assert torch.equal(got, want)
    trained = copy.deepcopy(model).train()
    _, out = trained(batch['input'])
    want = margipose_masked_loss(out, batch['target'], batch['joint_mask'], batch['valid_depth'],
                                 'jsd')
    stepped = copy.deepcopy(model)
    state = TrainState(stepped, make_optimiser('1cycle', stepped.parameters(), 1.0, max_iters=10))
    assert torch.equal(make_train_step('jsd')(state, batch)['loss'], want.detach())


def test_the_steps_take_the_integral_models_loss():
    ref, port = _pair()
    batch = _batch()
    evaluated = make_eval_step('jsd')(port, batch)
    with torch.no_grad():
        r_xyz, _ = ref.eval()(batch['input'])
    want = reference.masked_l1_loss(r_xyz, batch['target'], batch['joint_mask'],
                                    batch['valid_depth'])
    assert torch.allclose(evaluated['loss'], want, rtol=1e-5)
    assert torch.allclose(evaluated['pred'], r_xyz, atol=1e-5)

    from benchmark.reference import sgd

    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    state = TrainState(port, make_optimiser('1cycle', port.parameters(), 1.0, max_iters=10))
    out = make_train_step('jsd')(state, batch)
    r_loss, r_pred = reference.train_step(ref, sgd.OneCycleSGD(ref.parameters(), 1.0, 10), batch)
    assert torch.allclose(out['loss'], r_loss, rtol=1e-5)
    assert torch.allclose(out['pred'], r_pred, atol=1e-5)
    r_params = dict(ref.named_parameters())
    moved = [k for k, p in port.named_parameters() if not torch.equal(p, before[k])]
    assert len(moved) > 0.9 * len(before)
    for k in ('backbone.conv1.weight', 'head.features.0.weight', 'head.features.9.weight'):
        change = port.get_parameter(k).detach() - before[k]
        r_change = r_params[k].detach() - before[k]
        assert torch.allclose(change, r_change, rtol=1e-3, atol=1e-4 * float(r_change.abs().max()))


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """One CPU run of the train bin on an integral description: its result and
    its model-latest checkpoint."""
    out_dir = str(tmp_path_factory.mktemp('integral'))
    desc = f"model_desc={{'settings': {{'depth_dim': {DEPTH}, 'input_size': {SIZE}}}}}"
    result = train_3d.main(['--device', 'cpu', 'with', 'integral_model', 'synthetic', desc,
                            "train_datasets=['synthetic-16']", "val_datasets=['synthetic-4@1']",
                            'epochs=1', 'batch_size=2', 'train_examples=4', 'val_examples=2',
                            'num_workers=0', 'metrics_every=1', 'seed=3', f'out_dir={out_dir}',
                            'experiment_id=run'])
    return result, os.path.join(out_dir, 'run', 'model-latest')


def test_the_train_bin_trains_an_integral_description(trained):
    result, ckpt_dir = trained
    assert result['step'] == 2 and np.isfinite(result['train_loss'])
    model, desc = load_model(ckpt_dir, 'cpu')
    assert isinstance(model, IntegralPoseModel) and desc['type'] == 'integral'
    assert model.depth_dim == DEPTH
    fresh = create_model(desc, generator=torch.Generator().manual_seed(3)).state_dict()
    assert not torch.equal(model.state_dict()['head.features.9.weight'],
                           fresh['head.features.9.weight'])


def test_the_eval_bin_scores_an_integral_checkpoint(trained):
    _, ckpt_dir = trained
    rows, stats = eval_3d.main(['--model', ckpt_dir, '--dataset', 'synthetic-4',
                                '--batch-size', '2', '--device', 'cpu'])
    assert len(rows['mpjpe']) == 4 and np.isfinite(stats['mean_loss'])
    split, split_stats = eval_3d.main(['--model', ckpt_dir, '--dataset', 'synthetic-4',
                                       '--batch-size', '2', '--device', 'cpu',
                                       '--num-devices', '2'])
    assert np.allclose(split['mpjpe'], rows['mpjpe'])
    assert np.isclose(split_stats['mean_loss'], stats['mean_loss'], rtol=1e-5)


def test_infer_and_serve_run_an_integral_checkpoint(trained):
    _, ckpt_dir = trained
    model, desc = load_model(ckpt_dir, 'cpu')
    image = PIL.Image.open(os.path.join(ROOT, 'resources', 'man_running.jpg'))
    _, coords = infer_single.infer_image(model, image, desc, device='cpu')
    assert coords.shape == (17, 3) and np.isfinite(coords).all()
    runner, specs, served_desc = serve.make_runner(ckpt_dir, 'float32', 'cpu')
    frames = np.random.default_rng(0).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    answers = runner(frames)
    with torch.no_grad():
        want, _ = model(device_input(frames, CPU, specs.input_specs))
    assert served_desc == desc and answers.shape == (2, 17, 3)
    assert np.allclose(answers, want.numpy(), atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the soft-argmax kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_the_kernels_match_their_plain_versions(card, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    logits = (3 * torch.randn(2, 17 * DEPTH, 16, 16, generator=g, device=card)).to(dtype)
    grad = torch.randn(2, 17, 3, generator=g, device=card)
    xyz, stats = sa.softargmax3d_fwd(logits, DEPTH)
    want_xyz, want_stats = sa.softargmax3d_fwd_plain(logits, DEPTH)
    assert torch.allclose(xyz, want_xyz, atol=1e-5)
    assert torch.allclose(stats, want_stats, rtol=1e-5)
    dl = sa.softargmax3d_bwd(logits, DEPTH, xyz, stats, grad).float()
    want = sa.softargmax3d_bwd_plain(logits, DEPTH, want_xyz, want_stats, grad).float()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    assert torch.allclose(dl, want, rtol=rtol, atol=1e-5 * float(want.abs().max()))
