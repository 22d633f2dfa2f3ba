"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference (reference/).

Eval: relative L2 gaps ||program - reference|| / ||reference|| of each
stitched map, of the census sums and of the adjusted map, and the patch
visits the maps are short of. Training: the gap between the program's
and the reference's norm of a leaf's first gradient and of its change
over the first steps, over the larger of the reference leaf's norm and
the median leaf's, by the worst leaf and (the first gradient) the median
leaf; one minus the cosine between the program's and the reference's
change of all moving leaves together (Adam's step barely depends on the
gradient's scale or sign, so only this sees a backward whose sign is
wrong); the relative gap of each step's loss and of each sample's
population count; the samples the program assembled otherwise than the
region holds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

MAP_KEYS = ("map", "map_std", "scale", "scale_std", "adj")


def rel_l2(got, ref) -> float:
    got = torch.as_tensor(np.asarray(got, np.float64) if not isinstance(got, torch.Tensor) else got)
    ref = torch.as_tensor(np.asarray(ref, np.float64) if not isinstance(ref, torch.Tensor) else ref)
    got, ref = got.double().to(ref.device), ref.double()
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref).clamp(min=1e-30))


def eval_numbers(program: Dict, reference: Dict, levels: Sequence[str], missing_visits: int) -> Dict[str, float]:
    """``program``: the sampled map's outputs: the maps of MAP_KEYS and
    'census.<level>' / 'adj_census.<level>' sums in census row order."""
    out = {f"{k}_rel": rel_l2(program[k], reference[k]) for k in MAP_KEYS}
    out["census_rel"] = max(rel_l2(program[f"census.{lv}"], reference[f"census.{lv}"]) for lv in levels)
    out["adj_census_rel"] = max(rel_l2(program[f"adj_census.{lv}"], reference[f"adj_census.{lv}"])
                                for lv in levels)
    out["missing_visits"] = float(missing_visits)
    return out


# the program's parameter tree paths and the reference state dict's names
_BLOCK = {"inc": "inc.conv.conv", "down1": "down_seq.down1.mpconv.1.conv",
          "down2": "down_seq.down2.mpconv.1.conv"}
_STREAM = {"sar": "sar_stream", "opt": "optical_stream"}
_OUT = {"sar_out": "sar_out_conv.conv", "opt_out": "optical_out_conv.conv",
        "fusion_out": "fusion_out_conv.conv"}
_WB = {"w": "weight", "b": "bias"}


def reference_key(path: Tuple[str, ...]) -> str:
    """The reference name of a leaf of the program's parameter tree, e.g.
    ('unet', 'sar', 'up2', 'conv', 'conv1', 'w') ->
    'unetmodel.sar_stream.up_seq.up2.conv.conv.0.weight'."""
    wb = _WB[path[-1]]
    if path[0] == "head":
        return f"head.{2 * (int(path[1][1]) - 1)}.{wb}"
    if path[1] in _OUT:
        return f"unetmodel.{_OUT[path[1]]}.{wb}"
    stream, block = _STREAM[path[1]], path[2]
    if block in _BLOCK:
        return f"unetmodel.{stream}.{_BLOCK[block]}.{3 * (int(path[3][-1]) - 1)}.{wb}"
    if path[3] == "tconv":
        return f"unetmodel.{stream}.up_seq.{block}.up.{wb}"
    return f"unetmodel.{stream}.up_seq.{block}.conv.conv.{3 * (int(path[4][-1]) - 1)}.{wb}"


def reference_layout(path: Tuple[str, ...], v: torch.Tensor) -> torch.Tensor:
    """A leaf of the program's tree in the reference state dict's layout:
    convolutions (kh, kw, in, out) -> (out, in, kh, kw), transposed
    convolutions (in, kh, kw, out) -> (in, out, kh, kw), 1x1 convolutions
    (in, out) -> (out, in, 1, 1); biases as they are."""
    if v.dim() == 4:
        return v.permute(0, 3, 1, 2) if path[-2] == "tconv" else v.permute(3, 2, 0, 1)
    if v.dim() == 2:
        return v.t()[:, :, None, None]
    return v


def leaf_norms(pairs: Iterable[Tuple[Tuple[str, ...], torch.Tensor]]) -> Dict[str, float]:
    return {reference_key(p): float(torch.linalg.vector_norm(v.double())) for p, v in pairs}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> Dict[str, float]:
    """Each leaf's |program norm - reference norm| over the larger of the
    reference leaf's norm and the median leaf's."""
    med = float(np.median([ref[k] for k in ref]))
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def popcount_gap(got: Sequence, ref: Sequence) -> float:
    """The widest relative gap of a sample's population count over the
    checked steps; a sample the program did not count reads 1."""
    worst = 0.0
    for g, r in zip(got, ref):
        g, r = np.asarray(g, np.float64).ravel(), np.asarray(r, np.float64).ravel()
        if g.shape != r.shape:
            return 1.0
        worst = max(worst, float(np.max(np.abs(g - r) / np.maximum(np.abs(r), 1e-30))))
    return worst


def cosine_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys: List[str]) -> float:
    """1 - cos between the leaves ``keys`` of ``got`` and of ``ref``, each
    taken as one vector; 1 where either is zero."""
    dot = sum(float(torch.sum(got[k].double().cpu() * ref[k].double().cpu())) for k in keys)
    ng = sum(float(torch.sum(got[k].double() ** 2)) for k in keys) ** 0.5
    nr = sum(float(torch.sum(ref[k].double() ** 2)) for k in keys) ** 0.5
    return 1.0 - dot / (ng * nr) if ng > 0 and nr > 0 else 1.0


def train_numbers(program: Dict, reference: Dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """``program``: {'loss': [...], 'popcount': [...], 'grad1': {ref key: norm}, 'change':
    {ref key: tensor}}; ``reference``: run_steps' output. Returns the numbers
    and, for the two leaf gaps, the worst leaf's name. Leaves whose first
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone under Adam: they are left out of the change."""
    ref_g = {k: float(torch.linalg.vector_norm(v.double())) for k, v in reference["grad1"].items()}
    ref_c = {k: float(torch.linalg.vector_norm(v.double())) for k, v in reference["change"].items()}
    med_g = float(np.median(list(ref_g.values())))
    moving = [k for k in ref_c if ref_g[k] >= 1e-3 * med_g]
    g = leaf_gaps(program["grad1"], ref_g, list(ref_g))
    got_c = {k: float(torch.linalg.vector_norm(program["change"][k].double())) for k in moving}
    c = leaf_gaps(got_c, {k: ref_c[k] for k in moving}, moving)
    g_leaf, c_leaf = max(g, key=g.get), max(c, key=c.get)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(program["loss"], reference["loss"]))
    nums = {"loss_rel": loss_gap, "popcount_rel": popcount_gap(program["popcount"], reference["popcount"]),
            "grad1_leaf_gap": g[g_leaf], "grad1_median_gap": float(np.median(list(g.values()))),
            "change_leaf_gap": c[c_leaf],
            "change_cos_gap": cosine_gap(program["change"], reference["change"], moving),
            "batch_misses": float(reference["batch_misses"])}
    return nums, {"grad1_leaf_gap": g_leaf, "change_leaf_gap": c_leaf}
