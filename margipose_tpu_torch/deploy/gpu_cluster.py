#!/usr/bin/env python3
"""Launch the port's training on a GPU VM or a GKE cluster of H100 nodes.

Counterpart of ``deploy/tpu_vm.py`` (the JAX package's TPU launcher), with
its ``run()``/``--dry-run`` design and parser shape. Two backends:

  * ``gce-vm``  — ``gcloud compute instances create`` an A3 VM
    (``a3-highgpu-8g``: 8 H100 80GB), copy this repo to it, run the setup
    (the host packages, and the port installed without dependencies: its
    kernels are built by ``nvcc`` at first use, no JAX), then ``torchrun
    --standalone --nproc-per-node G -m margipose_tpu_torch.bin <command>``
    under nohup.
  * ``gke``     — a manifest of a headless Service and an Indexed Job of
    ``--nodes`` pods, each requesting ``nvidia.com/gpu: G`` on an
    ``nvidia-h100-80gb`` node and running ``torchrun_argv``: one torchrun
    agent a node, rendezvous at pod 0 (``<name>-0.<name>``, the Service's
    DNS name), node rank ``$(JOB_COMPLETION_INDEX)``. Each pod mounts the
    datasets' PVC read-only at ``/datasets``, the output PVC at ``/app/out``
    (``out`` under the image's working directory, where the train bin writes
    by default), and a memory-backed ``/dev/shm`` for NCCL and the loader.
    The output volume is one for every node: process 0 alone writes
    checkpoints (``train/checkpoint.py``), and every process of a
    ``resume=`` run reads them. So ``--output-pvc``, like ``--datasets-pvc``,
    names a claim that exists already, and it must be ``ReadWriteMany``
    (on GKE a Filestore class such as ``standard-rwx``, which needs the
    Filestore CSI driver; the default persistent-disk class is
    ``ReadWriteOnce`` only).

Every gcloud/kubectl interaction goes through ``run()`` so ``--dry-run``
prints the exact commands and manifests without side effects (the tests use
it; there is no cloud access in CI)::

    python -m margipose_tpu_torch.deploy.gpu_cluster --backend gke --name mp \\
        --nodes 2 --gpus-per-node 8 --dry-run -- train with margipose_model mpi3d
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
from os import path

REPO_ROOT = path.dirname(path.dirname(path.dirname(path.abspath(__file__))))
REMOTE_DIR = '~/margipose-tpu'
MASTER_PORT = 29500
# the train bin's default out_dir (`out`) under the image's WORKDIR
OUT_DIR = '/app/out'

SETUP_CMDS = (
    "sudo apt-get install -y g++ ffmpeg || true && "
    "pip install numpy scipy pillow h5py pandas tabulate tqdm && "
    f"pip install --no-deps -e {REMOTE_DIR}"
)


def run(cmd: list, dry_run: bool):
    print("+ " + " ".join(shlex.quote(c) for c in cmd), flush=True)
    if dry_run:
        return 0
    return subprocess.run(cmd).returncode


def torchrun_argv(command, nodes: int, gpus_per_node: int, node_rank, master_addr: str,
                  master_port: int = MASTER_PORT) -> list:
    """The torchrun agent of node ``node_rank`` (a number, or the pod's
    ``$(JOB_COMPLETION_INDEX)``) running the ``margipose`` command
    ``command`` on ``gpus_per_node`` processes; one node rendezvouses
    ``--standalone``."""
    if nodes == 1:
        where = ['--standalone']
    else:
        where = ['--nnodes', str(nodes), '--node-rank', str(node_rank),
                 '--master-addr', master_addr, '--master-port', str(master_port)]
    return ['torchrun', *where, '--nproc-per-node', str(gpus_per_node),
            '-m', 'margipose_tpu_torch.bin', *command]


def deploy_gce_vm(args) -> int:
    name = args.name
    zone = ["--zone", args.zone]

    rc = run(["gcloud", "compute", "instances", "create", name, *zone,
              "--machine-type", args.machine_type, "--maintenance-policy", "TERMINATE",
              "--image-family", args.image_family, "--image-project", args.image_project,
              "--boot-disk-size", "200GB"], args.dry_run)
    if rc:
        return rc

    rc = run(["gcloud", "compute", "scp", "--recurse", REPO_ROOT, f"{name}:{REMOTE_DIR}",
              *zone], args.dry_run)
    if rc:
        return rc

    rc = run(["gcloud", "compute", "ssh", name, *zone, "--command", SETUP_CMDS], args.dry_run)
    if rc:
        return rc

    agent = torchrun_argv(args.command, 1, args.gpus_per_node, 0, "localhost")
    train_cmd = (f"cd {REMOTE_DIR} && nohup " + " ".join(shlex.quote(c) for c in agent)
                 + " > train.log 2>&1 &")
    rc = run(["gcloud", "compute", "ssh", name, *zone, "--command", train_cmd], args.dry_run)
    if rc:
        return rc

    print(f"# started; follow with: gcloud compute ssh {name} --zone {args.zone} "
          f"--command 'tail -f {REMOTE_DIR}/train.log'")
    if args.auto_delete:
        print(f"# delete with: gcloud compute instances delete {name} --zone {args.zone}")
    return 0


def gke_manifest(args) -> str:
    """A headless Service (stable pod DNS names) and an Indexed Job of
    ``args.nodes`` pods, one torchrun agent each."""
    agent = torchrun_argv(args.command, args.nodes, args.gpus_per_node,
                          "$(JOB_COMPLETION_INDEX)", f"{args.name}-0.{args.name}")
    arg_list = "[" + ", ".join(repr(c) for c in agent[1:]) + "]"
    return f"""\
apiVersion: v1
kind: Service
metadata:
  name: {args.name}
spec:
  clusterIP: None
  selector:
    app: {args.name}
---
apiVersion: batch/v1
kind: Job
metadata:
  name: {args.name}
spec:
  completions: {args.nodes}
  parallelism: {args.nodes}
  completionMode: Indexed
  backoffLimit: 0
  template:
    metadata:
      labels: {{app: {args.name}}}
    spec:
      restartPolicy: Never
      subdomain: {args.name}
      nodeSelector:
        cloud.google.com/gke-accelerator: nvidia-h100-80gb
      containers:
      - name: train
        image: {args.image}
        command: ["{agent[0]}"]
        args: {arg_list}
        resources:
          requests: {{"nvidia.com/gpu": "{args.gpus_per_node}"}}
          limits: {{"nvidia.com/gpu": "{args.gpus_per_node}"}}
        volumeMounts:
        - {{name: datasets, mountPath: /datasets, readOnly: true}}
        - {{name: out, mountPath: {OUT_DIR}}}
        - {{name: dshm, mountPath: /dev/shm}}
        env:
        - {{name: MARGIPOSE_BASE_DATA_DIR, value: /datasets}}
      volumes:
      - name: datasets
        persistentVolumeClaim: {{claimName: {args.datasets_pvc}, readOnly: true}}
      - name: out
        persistentVolumeClaim: {{claimName: {args.output_pvc}}}
      - name: dshm
        emptyDir: {{medium: Memory}}
"""


def deploy_gke(args) -> int:
    manifest = gke_manifest(args)
    print(manifest)
    if args.dry_run:
        return 0
    proc = subprocess.run(["kubectl", "apply", "-f", "-"], input=manifest, text=True)
    return proc.returncode


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--backend", choices=["gce-vm", "gke"], default="gce-vm")
    parser.add_argument("--name", default="margipose", help="VM / job name")
    parser.add_argument("--zone", default="us-central1-a")
    parser.add_argument("--machine-type", default="a3-highgpu-8g")
    parser.add_argument("--image-family", default="pytorch-latest-gpu",
                        help="the VM's boot image family (CUDA and PyTorch)")
    parser.add_argument("--image-project", default="deeplearning-platform-release")
    parser.add_argument("--nodes", type=int, default=1, help="GKE: pods, one a node")
    parser.add_argument("--gpus-per-node", type=int, default=8)
    parser.add_argument("--image", default="margipose-tpu-torch:latest",
                        help="GKE: the container image (margipose_tpu_torch/deploy/Dockerfile)")
    parser.add_argument("--datasets-pvc", default="margipose-datasets")
    parser.add_argument("--output-pvc", default="margipose-out",
                        help="GKE: an existing ReadWriteMany claim, mounted at "
                             f"{OUT_DIR} on every node")
    parser.add_argument("--auto-delete", action="store_true")
    parser.add_argument("--dry-run", action="store_true",
                        help="print commands/manifests without executing")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="margipose command, e.g. -- train with margipose_model mpi3d")
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if not args.command:
        args.command = ["train", "with", "margipose_model", "mpi3d"]
    if args.backend == "gce-vm":
        return deploy_gce_vm(args)
    return deploy_gke(args)


if __name__ == "__main__":
    sys.exit(main())
