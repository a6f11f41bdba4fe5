"""A multi-node launch rehearsed on one machine: one torchrun agent a node,
each running the argv ``gpu_cluster.torchrun_argv`` emits for its pod, with
the master address ``127.0.0.1`` in place of pod 0's DNS name.

Each agent gets its own cards (``CUDA_VISIBLE_DEVICES``, renumbered from 0
in each agent as on a node of its own) and the probe (``probe/``) on
``PYTHONPATH``, which records what each worker was (global and local rank,
card), what it wrote under the output directory, and a digest of its
weights after each train step. ``kill_at=k`` SIGKILLs every agent and
worker (found through ``/proc``) once the run's ``model-latest`` says epoch k, then starts the agents
again with ``resume=`` added to the command, as a resubmitted Job would.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
from os import path

from margipose_tpu_torch.deploy.gpu_cluster import torchrun_argv
from margipose_tpu_torch.soak.run import saved_epoch

ROOT = path.dirname(path.dirname(path.dirname(path.abspath(__file__))))
PROBE = path.join(path.dirname(path.abspath(__file__)), 'probe')


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def agent_argv(command, nodes, procs_per_node, node_rank, master_port):
    """``torchrun_argv`` for one agent here: ``torchrun`` run as this
    interpreter's ``torch.distributed.run``."""
    argv = torchrun_argv(command, nodes, procs_per_node, node_rank, '127.0.0.1', master_port)
    return [sys.executable, '-m', 'torch.distributed.run', *argv[1:]]


def _start(command, nodes, procs_per_node, work, cards, env, launch):
    port = free_port()
    agents = []
    records = path.join(work, 'probe', f'launch{launch}')
    os.makedirs(records)
    for node in range(nodes):
        node_env = dict(env, MARGIPOSE_PROBE_DIR=records)
        if cards is not None:
            node_env['CUDA_VISIBLE_DEVICES'] = cards[node]
        log = open(path.join(work, f'launch{launch}-node{node}.log'), 'w')
        agents.append((subprocess.Popen(
            agent_argv(command, nodes, procs_per_node, node, port), cwd=ROOT, env=node_env,
            stdout=log, stderr=subprocess.STDOUT), log))
    return agents


def _descendants(pid):
    """The processes under ``pid``, from ``/proc`` (torchrun starts its
    workers in sessions of their own, out of reach of the agent's)."""
    children = {}
    for entry in os.listdir('/proc'):
        if entry.isdigit():
            try:
                with open(f'/proc/{entry}/stat') as f:
                    ppid = int(f.read().rpartition(')')[2].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            children.setdefault(ppid, []).append(int(entry))
    found, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            found.append(child)
            todo.append(child)
    return found


def _kill(agents):
    """SIGKILL each agent, then every process that was under it."""
    for proc, log in agents:
        if proc.poll() is None:
            below = _descendants(proc.pid)
            proc.kill()
            for pid in below:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        proc.wait()
        log.close()


def _logs(work):
    out = []
    for name in sorted(glob.glob(path.join(work, 'launch*-node*.log'))):
        with open(name) as f:
            out.append(f'--- {path.basename(name)}\n{f.read()[-2500:]}')
    return '\n'.join(out)


def rehearse(command, work, out_dir, nodes=2, procs_per_node=1, cards=None, kill_at=None,
             exp_dir=None, timeout=900, log=print):
    """Run the ``margipose`` command ``command`` as ``nodes`` agents of
    ``procs_per_node`` workers; ``cards``: each node's
    ``CUDA_VISIBLE_DEVICES``; ``out_dir``: the run's output directory, which
    the probe watches; ``kill_at``/``exp_dir``: the kill above. Returns the
    probe's records by launch (one, or two with a kill), in each one list of
    dicts a worker process; the logs are in ``work``."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [PROBE, ROOT] + ([os.environ['PYTHONPATH']] if os.environ.get('PYTHONPATH') else [])),
               MARGIPOSE_PROBE_WATCH=out_dir)
    env.setdefault('OMP_NUM_THREADS', '1')
    launch = 1
    agents = _start(command, nodes, procs_per_node, work, cards, env, launch)
    deadline = time.monotonic() + timeout
    try:
        if kill_at is not None:
            while saved_epoch(exp_dir) < kill_at:
                if any(p.poll() is not None for p, _ in agents) or time.monotonic() > deadline:
                    raise RuntimeError(f'the rehearsal ended or stalled before epoch {kill_at}'
                                       f':\n{_logs(work)}')
                time.sleep(0.02)
            _kill(agents)
            log(f'launch {launch}: every agent and worker SIGKILLed once model-latest said '
                f'epoch {kill_at}: it says {saved_epoch(exp_dir)}')
            shutil.copytree(path.join(exp_dir, 'model-latest'),
                            path.join(work, 'model-latest.killed'))
            launch += 1
            command = [*command, f"resume={path.join(exp_dir, 'model-latest')}"]
            agents = _start(command, nodes, procs_per_node, work, cards, env, launch)
        for proc, _ in agents:
            rc = proc.wait(max(deadline - time.monotonic(), 1))
            if rc:
                raise RuntimeError(f'an agent exited {rc}:\n{_logs(work)}')
    except subprocess.TimeoutExpired:
        raise RuntimeError(f'the rehearsal exceeded {timeout} s:\n{_logs(work)}') from None
    finally:
        _kill(agents)
    log(f'launch {launch}: ran to the end')
    launches = []
    for n in range(1, launch + 1):
        launches.append([])
        for name in sorted(glob.glob(path.join(work, 'probe', f'launch{n}', '*.jsonl'))):
            with open(name) as f:
                launches[-1].append([json.loads(line) for line in f])
    return launches
