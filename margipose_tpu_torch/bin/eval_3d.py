#!/usr/bin/env python3
"""Calculate 3D evaluation metrics for a trained model on the card.

Counterpart of ``margipose_tpu/bin/eval_3d.py`` (reference:
src/margipose/bin/eval_3d.py)::

    python -m margipose_tpu_torch.bin.eval_3d --model FILE.pth \\
        [--dataset mpi3d-test] --batch-size 32 [--precision bfloat16] \\
        [--ship auto|uint8|float32] [--multicrop] [--num-devices N] [--device cpu]

Each batch is padded to ``--batch-size``, uploaded, and run through the
forward pass and the masked loss under ``torch.inference_mode()``. With
``--multicrop`` each item is one example's 10 crops, unpadded, and yields one
crop-averaged prediction. ``--precision bfloat16`` runs the convolutions
under autocast (``parallel/precision.py``); ``--ship uint8`` uploads the
input as its exact source pixels and renormalises it on the device. Results
come back to the host in a window of in-flight batches: batch k is read only
after batches k+1..k+W have been enqueued, so the host-side geometry overlaps
the device instead of syncing every batch. Device time per batch comes from
CUDA events (host clock on the CPU). ``--num-devices N`` evaluates on N
cards in one process: one weight replica a card, each batch split into N
equal row blocks, the results gathered in row order.
"""

from __future__ import annotations

import argparse
import copy
import sys
from time import perf_counter

import numpy as np
import torch

from margipose_tpu_torch import resolve_device
from margipose_tpu_torch.checkpoint import load_model
from margipose_tpu_torch.cli import bin_subcommand
from margipose_tpu_torch.data.get_dataset import get_dataset
from margipose_tpu_torch.data.loader import make_dataloader, make_unbatched_dataloader
from margipose_tpu_torch.data.specs import device_input, to_device
from margipose_tpu_torch.eval import gather_3d_metrics, prepare_for_3d_evaluation
from margipose_tpu_torch.geometry.coords import ensure_homogeneous
from margipose_tpu_torch.geometry.skeleton import CanonicalSkeletonDesc, VNect_Common_Skeleton
from margipose_tpu_torch.models import data_specs_for_desc
from margipose_tpu_torch.models.margipose import margipose_joint_losses, margipose_masked_loss
from margipose_tpu_torch.parallel.precision import compute_dtype_scope, resolve_dtype
from margipose_tpu_torch.train.meters import MeanValueMeter, MedianValueMeter
from margipose_tpu_torch.utils import init_algorithms, seed_all

METRICS = ('aligned_auc', 'aligned_mpjpe', 'aligned_pck', 'auc', 'mpjpe', 'pck')


def parse_args(argv):
    parser = argparse.ArgumentParser(
        prog='margipose-torch-eval', description='3D human pose model evaluator',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--model', type=str, metavar='FILE', required=True,
                        help='path to a reference-format .pth model file')
    parser.add_argument('--dataset', type=str, metavar='DS', default='mpi3d-test',
                        help='dataset to evaluate on')
    parser.add_argument('--multicrop', action='store_true',
                        help='average each example\'s prediction over its 10 crops')
    parser.add_argument('--batch-size', type=int, metavar='N', default=1,
                        help='examples per forward pass (ignored with --multicrop); the tail '
                             'batch is padded')
    parser.add_argument('--precision', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help='compute dtype: float32 (TF32 off) is the checkpoint-parity mode; '
                             'bfloat16 runs the convolutions under autocast')
    parser.add_argument('--ship', type=str, default='auto', choices=['auto', 'uint8', 'float32'],
                        help='input upload encoding: uint8 re-quantises the input to its exact '
                             'source pixels (4x fewer bytes) and renormalises on the device, '
                             'which differs from the host normalisation at the last ulp; '
                             'float32 uploads the host-normalised input. auto: uint8 under '
                             'bfloat16, float32 under float32')
    parser.add_argument('--num-devices', type=int, metavar='N', default=1,
                        help='data-parallel evaluation: one weight replica on each of N '
                             'local cards (0 = all), each batch split into N equal row '
                             'blocks; batch-size must be divisible by N. Incompatible with '
                             '--multicrop (10-crop items are one example). On the CPU the N '
                             'replicas share the one device')
    parser.add_argument('--num-workers', type=int, metavar='N', default=0,
                        help='loader threads preparing upcoming batches')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device; 'cpu' runs the plain paths on the host")
    return parser.parse_args(argv)


def padded_batches(loader, batch_size, multicrop=False):
    """Host batches with the tail padded to ``batch_size`` by repeating its
    last example; padding rows are masked out of the loss. A multicrop item
    (one example's crops) is not padded."""
    for batch in loader:
        n_real = int(np.asarray(batch['valid_depth']).shape[0])
        pad = 0 if multicrop else max(batch_size - n_real, 0)

        def _pad(arr, dtype):
            arr = np.asarray(arr, dtype)
            if pad:
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)
            return np.ascontiguousarray(arr)

        out = dict(batch)
        out['n_real'] = n_real
        out['input'] = _pad(batch['input'], np.float32)
        out['target'] = _pad(batch['target'][..., :3], np.float32)
        out['valid_depth'] = _pad(batch['valid_depth'], np.int64)
        out['joint_mask'] = _pad(batch['joint_mask'], np.float32)
        out['joint_mask'][n_real:] = 0
        yield out


class DeviceClock:
    """CUDA events on the card, the host clock on the CPU (where every op
    has finished when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return perf_counter()

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def seconds(self, start, end):
        return start.elapsed_time(end) / 1000.0 if self.cuda else end - start


def _to_host(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == 'cuda':
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)
    return t.clone()


def obtain_predictions(forward, loader, device, known_depth=False, batch_size=1,
                       drain_window=4, print_progress=False, multicrop=False, ship_specs=None):
    """One prediction per real example (reference: src/margipose/bin/eval_3d.py:48-94).

    ``forward(images NCHW, target, mask, valid_depth) -> (xyz, loss)``. Each
    batch's first prediction carries the batch's device time per real
    example and its loss (weighted by ``loss_n`` real examples). With
    ``multicrop`` each loader item is one example's crops and yields one
    prediction, the mean over the crops of the untransformed skeletons, with
    the item's device time and loss."""
    clock = DeviceClock(device)
    batches = padded_batches(loader, batch_size, multicrop)
    if print_progress:
        try:
            from tqdm import tqdm

            batches = tqdm(batches, total=len(loader), leave=True, ascii=True)
        except ImportError:
            pass

    def _drain(entry):
        clock.wait(entry['done'])
        xyz = entry['xyz'].numpy().astype(np.float64)
        loss = float(entry['loss'])
        n_real = entry['n_real']
        seconds = clock.seconds(entry['start'], entry['end'])
        fr = entry['frame_ref']

        def frame_ref(i):
            if fr is None:
                return None
            return fr[i] if isinstance(fr, list) else {k: np.asarray(v)[i] for k, v in fr.items()}

        evaluated = [prepare_for_3d_evaluation(
            entry['original_skel'][i], norm_pred, loader.dataset,
            entry['camera_intrinsic'][i], entry['transform_opts'][i], known_depth=known_depth)
            for i, norm_pred in enumerate(ensure_homogeneous(xyz[:n_real], d=3))]
        if multicrop:  # one example's crops: average their predictions
            actual = np.stack([a for _, a in evaluated]).mean(0)
            yield dict(expected=evaluated[-1][0], actual=actual, frame_ref=frame_ref(0),
                       inference_time=seconds, loss=loss, loss_n=1)
            return
        for i, (expected, actual) in enumerate(evaluated):
            yield dict(expected=expected, actual=actual, frame_ref=frame_ref(i),
                       inference_time=seconds / n_real if i == 0 else None,
                       loss=loss if i == 0 else None, loss_n=n_real)

    pending = []
    for batch in batches:
        images = device_input(batch['input'], device, ship_specs)
        target = to_device(batch['target'], device)
        mask = to_device(batch['joint_mask'], device)
        valid_depth = to_device(batch['valid_depth'], device)
        start = clock.mark()
        xyz, loss = forward(images, target, mask, valid_depth)
        end = clock.mark()
        # only the small result copies and host metadata stay in flight
        pending.append(dict(
            xyz=_to_host(xyz), loss=_to_host(loss), done=clock.mark(), start=start, end=end,
            n_real=batch['n_real'], original_skel=batch['original_skel'],
            camera_intrinsic=batch['camera_intrinsic'],
            transform_opts=batch['transform_opts'], frame_ref=batch.get('frame_ref')))
        if len(pending) > drain_window:
            yield from _drain(pending.pop(0))
    for entry in pending:
        yield from _drain(entry)


def run_evaluation_3d(forward, loader, included_joints, device, known_depth=False,
                      batch_size=1, print_progress=False, multicrop=False, ship_specs=None):
    """(reference: src/margipose/bin/eval_3d.py:97-118)

    Returns (rows, stats): ``rows`` maps seq_id, activity_id and each metric
    to a per-example list; ``stats`` has the median device time per example,
    the mean loss, the number of batches run and each one's device seconds."""
    rows = {k: [] for k in ('seq_id', 'activity_id') + METRICS}
    loss_meter, time_meter, batch_seconds = MeanValueMeter(), MedianValueMeter(), []
    for pred in obtain_predictions(forward, loader, device, known_depth, batch_size,
                                   print_progress=print_progress, multicrop=multicrop,
                                   ship_specs=ship_specs):
        if pred['inference_time'] is not None:
            time_meter.add(pred['inference_time'])
            batch_seconds.append(pred['inference_time'] * pred['loss_n'])
        if pred['loss'] is not None:
            loss_meter.add(pred['loss'], pred['loss_n'])
        fr = pred['frame_ref']
        rows['seq_id'].append(f"TS{fr['subject_id']}/Seq{fr['sequence_id']}" if fr else '-')
        rows['activity_id'].append(fr['activity_id'] if fr else '-')
        for name, value in gather_3d_metrics(pred['expected'], pred['actual'],
                                             included_joints).items():
            rows[name].append(value)
    stats = dict(median_inference_time=time_meter.value(), mean_loss=loss_meter.value(),
                 batches=len(batch_seconds), batch_seconds=batch_seconds)
    return rows, stats


def _markdown(key, groups):
    """Markdown table: one row per group, the mean of each metric."""
    lines = ['| ' + ' | '.join((key,) + METRICS) + ' |',
             '|' + '---|' * (len(METRICS) + 1)]
    for name, values in groups.items():
        lines.append('| ' + ' | '.join(
            [str(name)] + [f'{float(np.mean(values[m])):.6g}' for m in METRICS]) + ' |')
    return '\n'.join(lines)


def metric_tables(rows) -> str:
    """The JAX bin's three tables: by sequence, by activity, overall."""
    def grouped(key):
        groups = {}
        for i, name in enumerate(rows[key]):
            g = groups.setdefault(name, {m: [] for m in METRICS})
            for m in METRICS:
                g[m].append(rows[m][i])
        return dict(sorted(groups.items(), key=lambda kv: str(kv[0])))

    overall = {'0': {m: rows[m] for m in METRICS}}
    return '\n'.join(['### By sequence\n', _markdown('seq_id', grouped('seq_id')),
                      '\n### By activity\n', _markdown('activity_id', grouped('activity_id')),
                      '\n### Overall\n', _markdown('', overall)])


def overall_metrics(rows) -> dict:
    return {m: float(np.mean(rows[m])) for m in METRICS}


def make_forward(model, pixelwise_loss, compute_dtype=None, distributed=False, group=None):
    """``forward(images, target, mask, valid_depth) -> (xyz, loss)``, both
    float32: the model runs under ``compute_dtype_scope``, the loss outside
    it (its heatmaps are float32 either way); with ``distributed``, over the
    global batch of ``group`` (the mesh's 'data' group; None: every
    process)."""
    def forward(images, target, mask, valid_depth):
        with torch.inference_mode():
            with compute_dtype_scope(compute_dtype, images.device):
                xyz, out = model(images)
            loss = margipose_masked_loss(out, target, mask, valid_depth, pixelwise_loss,
                                         distributed, group)
        return xyz.float(), loss
    return forward


def eval_devices(num_devices, device, batch_size, multicrop) -> list[torch.device]:
    """The devices ``--num-devices`` evaluates on: ``cuda:0..N-1`` on the card
    (0: every card), N times the one CPU device on the CPU (0: one). Raises
    SystemExit with the JAX bin's messages for a request it cannot run."""
    if device.type == 'cuda':
        available = torch.cuda.device_count()
        n_dev = num_devices if num_devices > 0 else available
        devices = [torch.device('cuda', i) for i in range(min(n_dev, available))]
    else:
        available = None
        n_dev = max(num_devices, 1)
        devices = [device] * n_dev
    if n_dev > 1:
        if multicrop:
            raise SystemExit(
                'eval: --num-devices > 1 requires batched mode; --multicrop '
                'items are one example and cannot shard over devices')
        if available is not None and n_dev > available:
            raise SystemExit(
                f'eval: --num-devices {n_dev} exceeds the {available} available device(s)')
        if batch_size % n_dev != 0:
            raise SystemExit(
                f'eval: --batch-size {batch_size} must be divisible by '
                f'--num-devices {n_dev}')
    return devices if n_dev > 1 else [device]


def make_data_parallel_forward(model, devices, pixelwise_loss, compute_dtype=None):
    """``make_forward``'s function over ``len(devices)`` weight replicas:
    each batch is split into equal row blocks, block i runs on replica i on
    ``devices[i]``, and the predictions come back to ``devices[0]`` in row
    order. The loss is the masked mean over the whole batch, from the blocks'
    numerators and denominators."""
    replicas = [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]

    def forward(images, target, mask, valid_depth):
        home = images.device
        blocks = zip(*(t.chunk(len(devices)) for t in (images, target, mask, valid_depth)))
        xyzs, nums, dens = [], [], []
        with torch.inference_mode():
            for replica, dev, block in zip(replicas, devices, blocks):
                x, t, m, v = (b.to(dev, non_blocking=True) for b in block)
                with compute_dtype_scope(compute_dtype, dev):
                    xyz, out = replica(x)
                losses = margipose_joint_losses(out, t, v, pixelwise_loss)
                nums.append((losses * m).sum().to(home))
                dens.append(m.sum().to(home))
                xyzs.append(xyz.float().to(home))
            loss = torch.stack(nums).sum() / torch.stack(dens).sum().clamp(min=1.0)
        return torch.cat(xyzs), loss
    return forward


def set_float32_parity_mode():
    """Full float32 on the card: cuDNN convolutions otherwise run in TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def main(argv=None, model=None):
    """Evaluate ``--model``'s checkpoint as ``argv`` says; returns (rows,
    stats). ``model``, a (module, model_desc) pair, is evaluated in place of
    reading ``--model``: the soaks evaluate the live train state so
    (``soak/child.py``)."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    seed_all(12345)
    # cuDNN's deterministic algorithms, whatever an earlier train run in the
    # process left (reference: src/margipose/bin/eval_3d.py)
    init_algorithms(deterministic=True)
    device = resolve_device(args.device)
    compute_dtype = resolve_dtype(args.precision)
    if compute_dtype == torch.float32:
        set_float32_parity_mode()
        print('Precision: float32, TF32 off for convolutions and matmuls (checkpoint parity)')
    else:
        print('Precision: bfloat16 autocast for the convolutions; float32 weights, BN '
              'statistics and loss head')
    # uint8's device renormalisation differs from the host's at the last ulp,
    # so auto keeps the float32 parity mode's input bit-identical
    ship = args.ship
    if ship == 'auto':
        ship = 'uint8' if args.precision == 'bfloat16' else 'float32'
    print(f'Input upload: {ship}')
    devices = eval_devices(args.num_devices, device, args.batch_size, args.multicrop)

    if model is None:
        model, model_desc = load_model(args.model, device)
    else:
        model, model_desc = model
        model = model.to(device).eval()
    dataset = get_dataset(args.dataset, data_specs_for_desc(model_desc), use_aug=False)
    ship_specs = dataset.data_specs.input_specs if ship == 'uint8' else None
    if args.multicrop:
        dataset.multicrop = True
        loader = make_unbatched_dataloader(dataset, num_workers=args.num_workers)
    else:
        loader = make_dataloader(dataset, batch_size=args.batch_size,
                                 num_workers=args.num_workers)

    if args.dataset.startswith('h36m-'):
        known_depth = True
        included_joints = list(range(CanonicalSkeletonDesc.n_joints))
    else:
        known_depth = False
        included_joints = [
            CanonicalSkeletonDesc.joint_names.index(n) for n in VNect_Common_Skeleton]
    print(f'Use ground truth root joint depth? {known_depth}')
    print(f'Number of joints in evaluation: {len(included_joints)}')

    pixelwise_loss = model_desc['settings'].get('pixelwise_loss', 'jsd')
    if len(devices) > 1:
        forward = make_data_parallel_forward(model, devices, pixelwise_loss, compute_dtype)
        print(f'Data-parallel eval over {len(devices)} devices')
    else:
        forward = make_forward(model, pixelwise_loss, compute_dtype)
    rows, stats = run_evaluation_3d(forward, loader, included_joints, device,
                                    known_depth=known_depth, batch_size=args.batch_size,
                                    print_progress=True, multicrop=args.multicrop,
                                    ship_specs=ship_specs)
    print(metric_tables(rows))
    t_med = stats['median_inference_time']
    print('\nmedian inference time: ' + (f'{t_med:.6f}s per example' if t_med else 'n/a'))
    if stats['batches']:
        total = sum(stats['batch_seconds'])
        what = 'example (all crops)' if args.multicrop else f'batch of {args.batch_size}'
        print(f"{'device' if device.type == 'cuda' else 'host'} time per {what}: "
              + ', '.join(f'{s * 1e3:.3f}' for s in stats['batch_seconds'])
              + f" ms; {len(rows['mpjpe']) / total:.1f} images/s over {stats['batches']} batches")
    print(f"mean loss: {stats['mean_loss']}")
    return rows, stats


Eval_Subcommand = bin_subcommand('eval', main, help='evaluate the accuracy of predictions')


if __name__ == '__main__':
    main()
