"""Model checkpoints: reference ``.pth`` files and the port's train-state
directories.

Counterpart of ``margipose_tpu/train/checkpoint.py::load_model``
(``:238-274``), which dispatches on the same two kinds: a ``.pth`` file in
the reference format ``{state_dict, model_desc}`` (reference:
src/margipose/bin/train_3d.py:374-382), or a directory written by the port's
train bin (``train/checkpoint.py``). A JAX orbax checkpoint reaches the port
through the JAX package's ``export_model -f torch``.
"""

from __future__ import annotations

from os import path

import torch

from margipose_tpu_torch import resolve_device
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.train import checkpoint as train_checkpoint


def save_model(path: str, model: torch.nn.Module, model_desc: dict) -> None:
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"state_dict": state, "model_desc": model_desc}, path)


def load_model(model_file: str, device="cuda"):
    """Returns (model in eval mode on ``device``, model_desc) from a ``.pth``
    file or a train-state directory. The weights load with ``strict=True``:
    a missing or surplus key is an error. ``device`` goes through
    ``resolve_device``: the card unless the caller asks for the CPU, and an
    error where there is no card."""
    device = resolve_device(device)
    if path.isdir(model_file):
        model_desc = train_checkpoint.load_meta(model_file)["model_desc"]
        state_dict = train_checkpoint.load_payload(model_file)["model"]
    else:
        details = torch.load(model_file, map_location="cpu", weights_only=False)
        model_desc, state_dict = details["model_desc"], details["state_dict"]
    model = create_model(model_desc)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval(), model_desc
