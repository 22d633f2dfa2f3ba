"""The eval fold at patch sizes whose sides are even but not multiples of
32, where the JAX package's fold runs its members unpadded (its packed
fold: both streams, pack factor 4 at 100, 2 at 102) and the reference's
padding rule would pad them to 128: the port's run_sliding_inference
against the JAX package's on the synthetic 192x256 region of
tests/test_torch_eval.py with its two .pth members (the repo's DDA
weights, seeded heads).

Bounds: float maps at test_torch_eval.py's MAP_TOL (rtol 2e-4, atol
2e-5), visit counts equal. The static int8 fold ('int8s') against the
JAX package's int8s fold: map correlation > 0.9999, the bound
tests/test_torch_quant_stream.py holds the int8s stream to (a code may
flip by one where a requant lands on a half), and it must run kernel E/F's
plain versions, as JAX's fold quantizes there."""

import jax
import numpy as np
import pytest
import torch

from popcorn_tpu.compat.torch_convert import load_popcorn_from_dda, save_popcorn_checkpoint
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.data.dataset import PopulationDataset as JDataset
from popcorn_tpu.data.synthetic import make_synthetic_region as j_make
from popcorn_tpu.infer.evaluator import load_member as j_load_member
from popcorn_tpu.infer.sliding import run_sliding_inference as j_run
from popcorn_tpu_torch.config import ModelConfig
from popcorn_tpu_torch.data.dataset import PopulationDataset
from popcorn_tpu_torch.infer.evaluator import load_member
from popcorn_tpu_torch.infer.sliding import run_sliding_inference
from popcorn_tpu_torch.nn import double_conv as dc
from popcorn_tpu_torch.nn import up_block as ub
from popcorn_tpu_torch.nn.popcorn import fold_unpadded

torch.set_num_threads(1)
MAP_TOL = dict(rtol=2e-4, atol=2e-5)
OVERLAP = 16
INT8S_CORR = 0.9999


def _dataset(cls, paths, patch):
    return cls(paths, "rwa", mode="test", patchsize=patch, overlap=OVERLAP,
               fourseasons=False, train_level="coarse")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fold_pad_data"))
    paths = j_make(root, "rwa", height=192, width=256, seed=21)
    mdir = tmp_path_factory.mktemp("fold_pad_members")
    cks = []
    for i in range(2):
        params, consts = load_popcorn_from_dda(
            JModelConfig(biasinit=0.9407), head_key=jax.random.PRNGKey(50 + i)
        )
        cks.append(str(mdir / f"m{i}.pth"))
        save_popcorn_checkpoint(cks[-1], params, consts)
    return paths, cks


def _runs(paths, cks, patch, quantize=None):
    jm = [j_load_member(p) for p in cks]
    ref = j_run([m[0] for m in jm], jm[0][1], JModelConfig(quantize=quantize),
                _dataset(JDataset, paths, patch))
    tm = [load_member(p) for p in cks]
    got = run_sliding_inference([m[0] for m in tm], tm[0][1], ModelConfig(quantize=quantize),
                                _dataset(PopulationDataset, paths, patch), device="cpu")
    return got, ref


@pytest.mark.parametrize("patch", [100, 102], ids=["pack4", "pack2"])
def test_fold_at_even_patch_matches_jax(setup, patch):
    paths, cks = setup
    got, ref = _runs(paths, cks, patch)
    for k in ("map", "scale"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), err_msg=k, **MAP_TOL)
    np.testing.assert_array_equal(got["count"], np.asarray(ref["count"]))
    assert got["map"].max() > 0


def test_int8s_fold_quantizes_where_jax_does(setup, monkeypatch):
    paths, cks = setup
    calls = {"E": 0, "F": 0}
    for key, mod, name in (("E", dc, "double_conv_qs_plain"), ("F", ub, "up_block_qs_plain")):
        fn = getattr(mod, name)

        def run(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, run)
    got, ref = _runs(paths, cks, 100, quantize="int8s")
    assert calls["E"] > 0 and calls["F"] > 0, calls
    a, b = np.asarray(ref["map"]).ravel(), got["map"].ravel()
    assert np.corrcoef(a, b)[0, 1] > INT8S_CORR
    np.testing.assert_array_equal(got["count"], np.asarray(ref["count"]))


@pytest.mark.parametrize("s1,s2,hw,want", [
    (True, True, (100, 100), True), (True, True, (102, 98), True), (True, True, (101, 100), False),
    (True, False, (100, 100), False), (False, True, (128, 128), False),
])
def test_fold_unpadded_follows_the_jax_fold(s1, s2, hw, want):
    assert fold_unpadded(ModelConfig(s1=s1, s2=s2), *hw) is want
