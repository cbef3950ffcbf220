"""Fine-tune dataset registry (counterpart of
``simhand_tpu/finetune/registry.py``; reference:
minimal-hand/datasets/__init__.py get_frame_dataset factory — name ->
dataset class). The keys of the benchmark readers raise
``NotImplementedError`` until those readers are ported."""
from __future__ import annotations

from typing import Any


# the readers of simhand_tpu/finetune/benchmarks.py, not ported yet
_NOT_PORTED = {
    "dexycb": "DexYCB", "dy": "DexYCB", "assemblyhands": "AssemblyHandsEgo",
    "ah": "AssemblyHandsEgo", "ah-ego": "AssemblyHandsEgo", "ah-exo": "AssemblyHandsExo",
    "stb": "STB", "rhd": "RHD", "cmu": "CMUHandLabels", "hand_labels": "CMUHandLabels",
    "hand143": "CMUPanoptic143", "panoptic": "CMUPanoptic143", "ganerated": "GANeratedHands",
    "gan": "GANeratedHands", "dexter_object": "DexterObject", "do": "DexterObject",
    "egodexter": "EgoDexter", "eo": "EgoDexter", "ego4d_hands": "Ego4DHands2D",
    "ego4d": "Ego4DHands2D",
}


def get_dataset(name: str, root_dir: str, split: str = "train", **kw) -> Any:
    """Instantiates a fine-tune/eval dataset by its reference name."""
    name = name.lower()
    if name in ("freihand", "fh"):
        from simhand_tpu_torch.finetune.datasets import FreiHand

        return FreiHand(root_dir, split, **kw)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r} ({_NOT_PORTED[name]}, simhand_tpu/finetune/benchmarks.py) "
            "is not ported yet (ROADMAP.md Queue 1 item 10)")
    if name == "synthetic":
        from simhand_tpu_torch.finetune.datasets import SyntheticPoseDataset

        return SyntheticPoseDataset(**kw)
    if name == "synthetic-hand":
        from simhand_tpu_torch.finetune.datasets import SyntheticPoseDataset

        return SyntheticPoseDataset(render_joints=True, **kw)
    raise KeyError(f"unknown dataset {name!r}")


DATASET_KEYS = (
    "freihand", "fh", "dexycb", "dy", "assemblyhands", "ah", "ah-ego",
    "ah-exo", "stb", "rhd", "cmu", "hand_labels", "hand143", "panoptic",
    "ganerated", "gan", "dexter_object", "do", "egodexter", "eo",
    "ego4d_hands", "ego4d", "synthetic", "synthetic-hand",
)

# keys whose constructor takes no split argument
_NO_SPLIT = {"hand143", "panoptic", "ganerated", "gan", "dexter_object",
             "do", "egodexter", "eo", "ego4d_hands", "ego4d", "synthetic",
             "synthetic-hand"}


def build_composed_dataset(
    names: str | list[str],
    roots: str | list[str],
    split: str = "train",
    setup: str = "s1",
    weights: list[float] | None = None,
    epoch_size: int | None = None,
    seed: int = 0,
    synthetic_n: int = 64,
):
    """Builds the (possibly multi-set) fine-tune dataset the reference's
    HandDataset hub assembles from ``subset_name=[...]``
    (minimal-hand/datasets/handataset.py:36-242).

    ``names``: one registry key or a comma-separated/explicit list.
    ``roots``: one root used for every set, or a list matching ``names``.
    No ``weights`` -> plain concatenation (reference index-routing
    semantics); ``weights`` -> deterministic per-sample weighted mix.
    """
    from simhand_tpu_torch.finetune.datasets import ConcatDataset, WeightedMixDataset

    if isinstance(names, str):
        names = [n.strip() for n in names.split(",") if n.strip()]
    if isinstance(roots, str):
        roots = [r.strip() or None for r in roots.split(",")]
    elif roots is None:
        roots = [None]
    if len(roots) == 1 and len(names) > 1:
        roots = list(roots) * len(names)
    assert len(roots) == len(names), (names, roots)

    sets = []
    for name, root in zip(names, roots):
        kw: dict = {}
        key = name.lower()
        if key in ("dexycb", "dy"):
            kw["setup"] = setup
        if key in ("synthetic", "synthetic-hand"):
            kw["n"] = synthetic_n
            kw["seed"] = 0 if split == "train" else 1
        if key in _NO_SPLIT:
            sets.append(get_dataset(key, root, **kw))
        else:
            sets.append(get_dataset(key, root, split, **kw))
    if len(sets) == 1 and weights is None:
        return sets[0]
    if weights is None:
        return ConcatDataset(sets)
    return WeightedMixDataset(sets, weights, epoch_size=epoch_size, seed=seed)
