"""The soaks: the whole 1cycle schedule and Chatterbox trained for long,
killed and resumed, and verified (the port of ``scripts/soak_*``).

  corpus.py    the fake MPI-INF-3DHP + MPII corpus (``make_soak_corpus.py``)
  recipes.py   the two recipes as ``bin/train_3d`` config words
  run.py       training processes started, SIGKILLed and resumed
  child.py     one training process: the train bin, then an eval of its
               live state
  verify.py    the checks (``soak_verify.py``)
  __main__.py  ``python -m margipose_tpu_torch.soak``
"""
