"""Launching the port on GPU machines (the counterpart of the repo's
``deploy/``, ``Dockerfile`` and ``docker-compose.yml.example``).

  gpu_cluster.py   a GCE A3 VM or a GKE Indexed Job of H100 nodes, one
                   torchrun agent a node (``--dry-run`` prints everything)
  rehearsal.py     the multi-node launch rehearsed on one machine, one
                   agent a node, with a probe in every worker (``probe/``)
  Dockerfile       the port's image (``docker build -f
                   margipose_tpu_torch/deploy/Dockerfile .`` at the repo root)
  docker-compose.yml.example
"""
