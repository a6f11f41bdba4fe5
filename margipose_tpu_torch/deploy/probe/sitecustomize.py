"""The multi-node rehearsal's probe (``deploy/rehearsal.py``), loaded by the
interpreter at start-up in every process of a rehearsal: the rehearsal puts
this directory first on ``PYTHONPATH``, so the processes run the torchrun
argv the launcher emits, unchanged.

In a torchrun worker (``RANK`` set) with ``MARGIPOSE_PROBE_DIR`` set, it
appends JSON lines to ``<dir>/rank<RANK>.<pid>.jsonl``: first the process's
ranks, world size and visible cards; then, from an audit hook, each file
opened for writing, renamed or removed under ``MARGIPOSE_PROBE_WATCH`` (the
run's output directory; creating a directory is not counted, every process
makes the shared experiment directory); and after each train step
(``train.steps.make_train_step``'s step, wrapped before the bin imports
it) the step number, the device and its card's PCI bus, the kernels'
launch counts so far, and a SHA-256 of the model's weights and buffers. Outside a rehearsal it does nothing.
"""

import os


def _install(record_dir, watch):
    import functools
    import hashlib
    import json
    import sys

    log = open(os.path.join(record_dir, f"rank{os.environ['RANK']}.{os.getpid()}.jsonl"), 'a')

    def emit(**fields):
        log.write(json.dumps(fields) + '\n')
        log.flush()

    emit(rank=int(os.environ['RANK']), local_rank=int(os.environ.get('LOCAL_RANK', 0)),
         world=int(os.environ['WORLD_SIZE']),
         visible=os.environ.get('CUDA_VISIBLE_DEVICES'), pid=os.getpid())
    watch = os.path.abspath(watch) + os.sep

    def under_watch(p):
        return isinstance(p, (str, bytes, os.PathLike)) and os.path.abspath(
            os.fsdecode(p)).startswith(watch)

    def audit(event, args):
        if event == 'open':
            p, mode, flags = args
            writes = (any(c in (mode or '') for c in 'wax+') if mode
                      else bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
            if writes and under_watch(p):
                emit(write='open', path=os.fsdecode(p))
        elif event in ('os.rename', 'os.remove', 'os.rmdir', 'shutil.rmtree'):
            if under_watch(args[0]):
                emit(write=event, path=os.fsdecode(args[0]))

    sys.addaudithook(audit)

    from margipose_tpu_torch.ops import launch_counts
    from margipose_tpu_torch.train import steps

    make_train_step = steps.make_train_step

    def probed_make_train_step(*args, **kwargs):
        train_step = make_train_step(*args, **kwargs)

        @functools.wraps(train_step)
        def probed(state, batch):
            metrics = train_step(state, batch)
            digest = hashlib.sha256()
            for key, value in state.model.state_dict().items():
                digest.update(key.encode() + value.detach().cpu().numpy().tobytes())
            device = next(state.model.parameters()).device
            bus = None
            if device.type == 'cuda':
                import torch

                props = torch.cuda.get_device_properties(device)
                bus = str(getattr(props, 'pci_bus_id', None) or getattr(props, 'uuid', ''))
            emit(step=state.step, digest=digest.hexdigest(), device=str(device), card=bus,
                 launches=list(launch_counts('dsnt_jsd_fwd', 'dsnt_jsd_bwd').values()))
            return metrics

        return probed

    steps.make_train_step = probed_make_train_step


if 'RANK' in os.environ and os.environ.get('MARGIPOSE_PROBE_DIR'):
    _install(os.environ['MARGIPOSE_PROBE_DIR'], os.environ['MARGIPOSE_PROBE_WATCH'])
