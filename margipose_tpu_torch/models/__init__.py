"""Model registry: create models from versioned ``model_desc`` dicts.

Counterpart of ``margipose_tpu/models/__init__.py`` and ``models/factory.py``
(reference: src/margipose/models/__init__.py:10-34, model_factory.py:1-18):
a ``{type, version, settings}`` dict is dispatched by type and a caret
semver range such as ``^6.0.0``.
"""

from __future__ import annotations

from margipose_tpu_torch.data.specs import DataSpecs, ImageSpecs, JointsSpecs
from margipose_tpu_torch.geometry.skeleton import CanonicalSkeletonDesc
from margipose_tpu_torch.models.chatterbox import ChatterboxModel, Default_Chatterbox_Desc
from margipose_tpu_torch.models.margipose import Default_MargiPose_Desc, MargiPoseModel


def parse_version(version: str) -> tuple[int, int, int]:
    parts = version.split("-")[0].split("+")[0].split(".")
    nums = [int(p) for p in parts[:3]]
    while len(nums) < 3:
        nums.append(0)
    return tuple(nums)


def caret_match(spec: str, version: str) -> bool:
    """True iff ``version`` satisfies a caret range ``^X.Y.Z``
    (>= X.Y.Z and below the next major; for 0.x below the next minor)."""
    assert spec.startswith("^"), f"only caret ranges are supported, got {spec!r}"
    base = parse_version(spec[1:])
    v = parse_version(version)
    if v < base:
        return False
    if base[0] > 0:
        return v[0] == base[0]
    if base[1] > 0:
        return v[0] == 0 and v[1] == base[1]
    return v[:2] == (0, 0)


def default_data_specs(input_size: int = 256) -> DataSpecs:
    """256x256 ImageNet-normalised crops in, canonical 17-joint 3D skeletons
    out (reference: src/margipose/models/margipose_model.py:206-209)."""
    return DataSpecs(
        ImageSpecs(input_size, mean=ImageSpecs.IMAGENET_MEAN,
                   stddev=ImageSpecs.IMAGENET_STDDEV),
        JointsSpecs(CanonicalSkeletonDesc, n_dims=3),
    )


def data_specs_for_desc(model_desc: dict) -> DataSpecs:
    """DataSpecs a model_desc dictates; the optional ``input_size`` setting
    (default 256) supports small configurations."""
    return default_data_specs(model_desc.get("settings", {}).get("input_size", 256))


def _create_margipose(model_desc: dict, generator=None) -> MargiPoseModel:
    s = model_desc["settings"]
    return MargiPoseModel(
        n_joints=CanonicalSkeletonDesc.n_joints,
        n_stages=s.get("n_stages", 4),
        axis_permutation=s.get("axis_permutation", True),
        feature_extractor=s.get("feature_extractor", "inceptionv4"),
        pixelwise_loss=s.get("pixelwise_loss", "jsd"),
        generator=generator,
    )


def _create_chatterbox(model_desc: dict, generator=None) -> ChatterboxModel:
    return ChatterboxModel(
        n_joints=CanonicalSkeletonDesc.n_joints,
        pixelwise_loss=model_desc["settings"].get("pixelwise_loss", "jsd"),
        generator=generator,
    )


# (type, caret range, constructor)
MODEL_FACTORIES = [
    ("margipose", "^6.0.0", _create_margipose),
    ("chatterbox", "^1.3.0", _create_chatterbox),
]


def create_model(model_desc: dict, generator=None):
    """Build the model for ``model_desc``; ``generator`` seeds its init."""
    for type_name, spec, create in MODEL_FACTORIES:
        if model_desc["type"] == type_name and caret_match(spec, model_desc["version"]):
            return create(model_desc, generator)
    raise ValueError(f"unrecognised model {model_desc['type']} v{model_desc['version']}")


__all__ = [
    "Default_Chatterbox_Desc",
    "Default_MargiPose_Desc",
    "MODEL_FACTORIES",
    "create_model",
    "data_specs_for_desc",
    "default_data_specs",
]
