"""ImageNet-pretrained stems: graft a backbone's weights onto a model's in_cnn.

The port's own copy of ``convert_pretrained_stem`` / ``load_pretrained_stem``
(``margipose_tpu/train/torch_import.py:219-304``). The reference initialises
the margipose in_cnn from ImageNet weights (pretrainedmodels
``inceptionv4(pretrained=...)`` / torchvision
``resnet{18,34,50}(pretrained=True)``; reference:
src/margipose/models/margipose_model.py:104-138); this module takes the same
state_dicts from a local ``.pth`` file. The port's keys already are the
reference's, so a backbone key is the stem key with its head renamed.
"""

from __future__ import annotations

import torch

# in_cnn child -> torchvision resnet attribute (the reference Sequential's
# indices 0=conv1, 1=bn1, 4=layer1, 5=layer2; 6/7 are the fresh 1x1
# reduction for resnet50 and keep their initialisation).
_RESNET_STEM_HEADS = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2"}
# inceptionv4: in_cnn children '0'..'6' are pretrainedmodels features.0..6;
# '7'/'8' are the fresh 1x1 conv + BN.
_INCEPTION_PRETRAINED_BLOCKS = {str(i) for i in range(7)}


def _stem_key(rel: list[str], feature_extractor: str) -> str | None:
    """Backbone state_dict key for an in_cnn-relative key, or None if the
    backbone does not cover it."""
    if feature_extractor == "inceptionv4":
        if rel[0] not in _INCEPTION_PRETRAINED_BLOCKS:
            return None
        return "features." + ".".join(rel)
    if feature_extractor.startswith("resnet"):
        head = _RESNET_STEM_HEADS.get(rel[0])
        return None if head is None else ".".join([head, *rel[1:]])
    raise ValueError(f"unsupported feature extractor: {feature_extractor}")


def convert_pretrained_stem(state_dict, pretrained, feature_extractor: str) -> dict:
    """``state_dict`` with its in_cnn stem entries overwritten by ImageNet
    weights from a backbone ``pretrained`` state_dict (pretrainedmodels
    inceptionv4 or torchvision resnet18/34/50 format).

    Leaves the fresh layers (the 1x1 reduction conv + BN), everything
    outside in_cnn and the ``num_batches_tracked`` counters (the JAX package
    has none) untouched. Raises on a missing key or a shape mismatch;
    surplus backbone keys (deeper blocks, the classifier) are expected and
    ignored. Returns a new dict."""
    n_loaded = 0
    out = dict(state_dict)
    for key, value in state_dict.items():
        parts = key.split(".")
        if "in_cnn" not in parts or parts[-1] == "num_batches_tracked":
            continue
        src = _stem_key(parts[parts.index("in_cnn") + 1:], feature_extractor)
        if src is None:
            continue
        if src not in pretrained:
            raise KeyError(f"pretrained state_dict is missing '{src}' (for {key})")
        w = torch.as_tensor(pretrained[src])
        if tuple(w.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch for {src}: {tuple(w.shape)} vs expected "
                             f"{tuple(value.shape)}")
        out[key] = w.to(value.dtype).clone()
        n_loaded += 1
    if n_loaded == 0:
        raise ValueError("no stem leaves matched the pretrained state_dict")
    return out


def load_pretrained_stem(model: torch.nn.Module, path: str, feature_extractor: str) -> None:
    """Load a backbone ``.pth`` file (a bare state_dict, or a dict with a
    'state_dict' entry) and graft it onto ``model``'s in_cnn stem, in place."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    model.load_state_dict(convert_pretrained_stem(model.state_dict(), obj, feature_extractor),
                          strict=True)
