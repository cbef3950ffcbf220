"""Fine-tune dataset registry (counterpart of
``simhand_tpu/finetune/registry.py``; reference:
minimal-hand/datasets/__init__.py get_frame_dataset factory — name ->
dataset class). Every key builds its reader: FreiHAND and the synthetic
sets from ``finetune/datasets.py``, the benchmarks from
``finetune/benchmarks.py``."""
from __future__ import annotations

from typing import Any


def get_dataset(name: str, root_dir: str, split: str = "train", **kw) -> Any:
    """Instantiates a fine-tune/eval dataset by its reference name."""
    from simhand_tpu_torch.finetune import benchmarks as B
    from simhand_tpu_torch.finetune import datasets as D

    name = name.lower()
    if name in ("freihand", "fh"):
        return D.FreiHand(root_dir, split, **kw)
    if name in ("dexycb", "dy"):
        return B.DexYCB(root_dir, split, **kw)
    if name in ("assemblyhands", "ah", "ah-ego"):
        return B.AssemblyHandsEgo(root_dir, split, **kw)
    if name == "ah-exo":
        return B.AssemblyHandsExo(root_dir, split, **kw)
    if name == "stb":
        return B.STB(root_dir, split)
    if name == "rhd":
        return B.RHD(root_dir, split)
    if name in ("cmu", "hand_labels"):
        return B.CMUHandLabels(root_dir, split)
    if name in ("hand143", "panoptic"):
        return B.CMUPanoptic143(root_dir)
    if name in ("ganerated", "gan"):
        return B.GANeratedHands(root_dir)
    if name in ("dexter_object", "do"):
        return B.DexterObject(root_dir)
    if name in ("egodexter", "eo"):
        return B.EgoDexter(root_dir)
    if name in ("ego4d_hands", "ego4d"):
        return B.Ego4DHands2D(root_dir, **kw)
    if name == "synthetic":
        return D.SyntheticPoseDataset(**kw)
    if name == "synthetic-hand":
        return D.SyntheticPoseDataset(render_joints=True, **kw)
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
