"""The port's launcher and image (``margipose_tpu_torch/deploy``), on the CPU.

* The GKE manifests mirror ``tests/test_deploy.py``'s four cases for GPU
  shapes: one node of 8 and two nodes of 8 H100s, ``nvidia.com/gpu``, the
  shared output volume (an existing claim), ``/dev/shm``, and each pod's
  torchrun argv naming ``margipose_tpu_torch.bin``, with no JAX anywhere.
  The ``gce-vm`` dry run prints its gcloud commands; the Dockerfile's
  ``COPY`` sources exist.
* The two-node rehearsal (``deploy/rehearsal.py``): two torchrun agents
  running the argv the manifest gives pods 0 and 1, gloo and ``--device
  cpu``: global ranks 0 and 1, both at ``LOCAL_RANK`` 0, files written by
  rank 0 only, every step's weights equal in both processes, and the
  checkpoint equal bit for bit to a ``--standalone --nproc-per-node 2``
  run's. ``-m slow`` adds a kill of both agents after the first checkpoint
  and a resume across them.
"""

import concurrent.futures
import os
import re
import shlex

import pytest
import torch

from margipose_tpu_torch.deploy import gpu_cluster, rehearsal
from margipose_tpu_torch.train import checkpoint as ckpt
from test_torch_train_bin import _assert_states_equal

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(ROOT, 'margipose_tpu_torch', 'deploy')
COMMAND = ['train', 'with', 'margipose_model', 'mpi3d']


def _args(*extra, backend='gke'):
    argv = ['--backend', backend, '--name', 't', '--dry-run', *extra, '--', *COMMAND]
    return gpu_cluster.make_parser().parse_args(argv)


def _manifest(*extra):
    args = _args(*extra)
    args.command = args.command[1:]
    return gpu_cluster.gke_manifest(args)


def _pod_argv(manifest):
    command = re.search(r'command: \["(\w+)"\]', manifest)[1]
    args = re.search(r'args: \[(.*)\]', manifest)[1]
    return [command] + [a.strip("'") for a in args.split(', ')]


@pytest.mark.parametrize('nodes,gpus', [(1, 8), (2, 8), (4, 8), (2, 4)])
def test_gke_manifest_gpu_shapes(nodes, gpus):
    m = _manifest('--nodes', str(nodes), '--gpus-per-node', str(gpus))
    assert f'completions: {nodes}' in m and f'parallelism: {nodes}' in m
    assert f'"nvidia.com/gpu": "{gpus}"' in m
    assert 'cloud.google.com/gke-accelerator: nvidia-h100-80gb' in m
    assert 'claimName: margipose-out' in m and 'kind: PersistentVolumeClaim' not in m
    assert '{name: out, mountPath: /app/out}' in m
    assert 'emptyDir: {medium: Memory}' in m and 'mountPath: /dev/shm' in m
    assert '{name: datasets, mountPath: /datasets, readOnly: true}' in m
    assert 'jax' not in m.lower() and 'google.com/tpu' not in m
    want = gpu_cluster.torchrun_argv(COMMAND, nodes, gpus, '$(JOB_COMPLETION_INDEX)', 't-0.t')
    assert _pod_argv(m) == want
    assert want[-len(COMMAND) - 2:-len(COMMAND)] == ['-m', 'margipose_tpu_torch.bin']
    if nodes == 1:
        assert '--standalone' in want
    else:
        assert want[:11] == ['torchrun', '--nnodes', str(nodes), '--node-rank',
                             '$(JOB_COMPLETION_INDEX)', '--master-addr', 't-0.t',
                             '--master-port', '29500', '--nproc-per-node', str(gpus)]


def test_gce_vm_dry_run_prints_its_commands(capsys):
    assert gpu_cluster.main(['--name', 'vm', '--dry-run', '--', *COMMAND]) == 0
    lines = capsys.readouterr().out.splitlines()
    commands = [shlex.split(line[2:]) for line in lines if line.startswith('+ ')]
    assert [c[:4] for c in commands] == [['gcloud', 'compute', 'instances', 'create'],
                                         ['gcloud', 'compute', 'scp', '--recurse'],
                                         ['gcloud', 'compute', 'ssh', 'vm'],
                                         ['gcloud', 'compute', 'ssh', 'vm']]
    create = commands[0]
    assert create[create.index('--machine-type') + 1] == 'a3-highgpu-8g'
    setup = commands[2][-1]
    assert 'pip install --no-deps -e' in setup and 'jax' not in setup
    train = commands[3][-1]
    assert ('nohup torchrun --standalone --nproc-per-node 8 -m margipose_tpu_torch.bin train '
            'with margipose_model mpi3d > train.log') in train


def test_dockerfile_copies_what_the_repo_has():
    with open(os.path.join(DEPLOY, 'Dockerfile')) as f:
        text = f.read()
    copies = re.findall(r'^COPY (\S+) ', text, re.M)
    assert copies == ['pyproject.toml', 'margipose_tpu_torch', 'resources']
    for source in copies:
        assert os.path.exists(os.path.join(ROOT, source)), source
    assert re.search(r'^FROM pytorch/pytorch:[\w.]+-cuda[\w.-]+-devel$', text, re.M)
    assert 'ENTRYPOINT ["margipose_torch"]' in text and 'jax' not in text.lower()
    assert '--no-deps' in text and 'h5py' in text
    with open(os.path.join(DEPLOY, 'docker-compose.yml.example')) as f:
        compose = f.read()
    assert 'dockerfile: margipose_tpu_torch/deploy/Dockerfile' in compose
    assert 'capabilities: [gpu]' in compose and 'privileged: true' not in compose


DESC = "model_desc={'settings': {'n_stages': 1, 'input_size': 64}}"


def _command(out, experiment_id, epochs=2):
    return ['--device', 'cpu', 'train', 'with', 'margipose_model', 'synthetic', DESC,
            "train_datasets=['synthetic-16']", 'val_datasets=[]', f'epochs={epochs}',
            'batch_size=4', 'train_examples=8', 'val_examples=0', 'num_workers=0', 'seed=3',
            f'out_dir={out}', f'experiment_id={experiment_id}']


def _check_two_agents(processes, out):
    heads = sorted((p[0] for p in processes), key=lambda h: h['rank'])
    assert [(h['rank'], h['local_rank'], h['world']) for h in heads] == [(0, 0, 2), (1, 0, 2)]
    writers = {p[0]['rank'] for p in processes if any('write' in r for r in p)}
    assert writers == {0}
    steps = {}
    for p in processes:
        for r in p:
            if 'step' in r:
                steps.setdefault(r['step'], set()).add(r['digest'])
    assert all(len(d) == 1 for d in steps.values()), steps
    return sorted(steps)


def test_two_node_rehearsal_equals_a_standalone_run(tmp_path):
    """The two launches side by side: four one-thread processes."""
    out = str(tmp_path / 'out')
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        two = pool.submit(rehearsal.rehearse, _command(out, 'two'), str(tmp_path / 'two'), out,
                          nodes=2, procs_per_node=1, timeout=600)
        one = pool.submit(rehearsal.rehearse, _command(out, 'one'), str(tmp_path / 'one'), out,
                          nodes=1, procs_per_node=2, timeout=600)
        (two,), (one,) = two.result(), one.result()
    assert _check_two_agents(two, out) == [1, 2, 3, 4]
    written = {r['path'] for p in two for r in p if 'write' in r}
    assert os.path.join(out, 'two', 'metrics.jsonl') in written
    with open(tmp_path / 'two' / 'launch1-node1.log') as f:
        assert 'torch.distributed: process 1/2 (gloo) on cpu' in f.read()
    assert sorted(p[0]['local_rank'] for p in one) == [0, 1]
    _assert_states_equal(ckpt.load_payload(os.path.join(out, 'two', 'model-latest')),
                         ckpt.load_payload(os.path.join(out, 'one', 'model-latest')))


@pytest.mark.slow
def test_two_node_rehearsal_killed_and_resumed_across_both_agents(tmp_path):
    out = str(tmp_path / 'out')
    killed, resumed = rehearsal.rehearse(
        _command(out, 'two', epochs=3), str(tmp_path / 'two'), out, nodes=2, procs_per_node=1,
        kill_at=1, exp_dir=os.path.join(out, 'two'), timeout=900)
    assert _check_two_agents(killed, out)[0] == 1
    assert _check_two_agents(resumed, out)[-1] == 6
    assert ckpt.load_payload(os.path.join(out, 'two', 'model-latest'))['step'] == 6


def test_the_image_and_the_vm_setup_install_ffmpeg(capsys):
    """``margipose_torch_preprocess_mpi3d`` extracts the train/val videos'
    frames with ffmpeg and raises without it, so the image and the VM setup
    install it beside g++, as the JAX package's ``Dockerfile`` and
    ``deploy/tpu_vm.py`` do."""
    with open(os.path.join(DEPLOY, 'Dockerfile')) as f:
        apt = re.search(r'apt-get install -y --no-install-recommends ([^\\\n]+)', f.read())[1]
    assert apt.split() == ['g++', 'ffmpeg']
    assert 'apt-get install -y g++ ffmpeg ' in gpu_cluster.SETUP_CMDS
    assert gpu_cluster.main(['--name', 'vm', '--dry-run', '--', *COMMAND]) == 0
    setup = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith('+ gcloud compute ssh') and 'apt-get' in line]
    assert len(setup) == 1 and 'g++ ffmpeg' in setup[0]


def test_the_image_pins_the_torch_its_comment_names():
    """The base image's tag is the torch and CUDA series the comment above
    it names, the one the port runs on (``torch.__version__`` and
    ``torch.version.cuda`` on the card)."""
    with open(os.path.join(DEPLOY, 'Dockerfile')) as f:
        text = f.read()
    tag = re.search(r'^FROM pytorch/pytorch:(\d+\.\d+\.\d+)-cuda(\d+)\.(\d+)-cudnn9-devel$',
                    text, re.M)
    named = re.findall(r'^#.*\btorch (\d+\.\d+\.\d+)\+cu(\d+)\b', text, re.M)
    assert tag and len(named) == 1, (tag, named)
    assert named[0] == (tag[1], tag[2] + tag[3])
    assert re.search(rf'^#.*\bCUDA {tag[2]}\.{tag[3]} nvcc\b', text, re.M)
