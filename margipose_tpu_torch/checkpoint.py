"""Model checkpoints in the reference ``.pth`` format ``{state_dict, model_desc}``
(reference: src/margipose/bin/train_3d.py:374-382).

Counterpart of ``margipose_tpu/train/checkpoint.py::load_model`` for torch
files only; a JAX orbax checkpoint reaches the port through the JAX package's
``export_model -f torch``.
"""

from __future__ import annotations

import torch

from margipose_tpu_torch.models import create_model


def save_model(path: str, model: torch.nn.Module, model_desc: dict) -> None:
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"state_dict": state, "model_desc": model_desc}, path)


def load_model(path: str, device="cpu"):
    """Returns (model in eval mode on ``device``, model_desc). The weights load
    with ``strict=True``: a missing or surplus key is an error."""
    details = torch.load(path, map_location="cpu", weights_only=False)
    model_desc = details["model_desc"]
    model = create_model(model_desc)
    model.load_state_dict(details["state_dict"], strict=True)
    return model.to(device).eval(), model_desc
