"""The port's whole-frame inference (popcorn_tpu_torch/infer/spatial.py)
against the JAX package's (popcorn_tpu/infer/spatial.py, on its
8-virtual-device CPU mesh) and against the JAX single-device forward, on
the same numpy-seeded frames and the JAX package's weights (carried by
compat/weights.py): on one rank, and on two gloo CPU ranks (one spawn for
the module, tests/torch_rank_suites.py::spatial_suite).

Tolerances are tests/test_spatial.py's: a whole-frame map against the
single-device forward rtol 1e-5 / atol 1e-6 (the port's strips and rank
blocks carry 64 rows of true context, the bound the JAX package's own
strips rest on); the mesh path against the patch path rtol 2e-5 / atol
2e-6; stitched interiors against whole-frame output rtol 2e-4 / atol
2e-5."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.compat.torch_convert import save_popcorn_checkpoint
from popcorn_tpu.config import DataPaths as JDataPaths
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.data.dataset import PopulationDataset as JDataset
from popcorn_tpu.data.normalize import NormStats as JNormStats
from popcorn_tpu.data.normalize import normalize_and_assemble as j_normalize
from popcorn_tpu.data.synthetic import make_synthetic_region as j_make
from popcorn_tpu.dist.mesh import make_mesh as j_make_mesh
from popcorn_tpu.infer import spatial as jsp
from popcorn_tpu.infer.sliding import stack_ensemble
from popcorn_tpu.infer.timeseries import builtup_map as j_builtup_map
from popcorn_tpu.nn.init import init_head as j_init_head
from popcorn_tpu.nn.init import init_popcorn as j_init
from popcorn_tpu.nn.popcorn import create_building_score as j_score
from popcorn_tpu.nn.popcorn import popcorn_forward as j_forward
from popcorn_tpu_torch.cli import eval as eval_cli
from popcorn_tpu_torch.compat.weights import from_jax, load_popcorn_checkpoint
from popcorn_tpu_torch.config import DataPaths, ModelConfig
from popcorn_tpu_torch.data.dataset import PopulationDataset
from popcorn_tpu_torch.data.normalize import NormStats, normalize_and_assemble
from popcorn_tpu_torch.dist.launch import spawn_ranks
from popcorn_tpu_torch.dist.mesh import make_mesh
from popcorn_tpu_torch.infer import spatial as sp
from popcorn_tpu_torch.infer.sliding import run_sliding_inference
from popcorn_tpu_torch.infer.timeseries import builtup_map
from popcorn_tpu_torch.io.geotiff import GeoTIFF
from popcorn_tpu_torch.nn.popcorn import create_building_score
from torch_rank_suites import CPU2, spatial_suite

torch.set_num_threads(1)
EXACT = dict(rtol=1e-5, atol=1e-6)
PATCH_PATH = dict(rtol=2e-5, atol=2e-6)
INTERIOR = dict(rtol=2e-4, atol=2e-5)
# 'tall': two ranks' row blocks of 224 rows each read 352 of the 448 rows,
# so a block's edge lies inside the frame (the others fit one window)
FRAMES = {"a": (160, 96, 0), "pad": (100, 50, 3), "b": (96, 64, 5), "tall": (448, 64, 9)}
MCFG = ModelConfig(pretrained=False)


def _frame(h, w, seed=0):
    rng = np.random.default_rng(seed)
    s2 = rng.uniform(0, 4000, (h, w, 4)).astype(np.float32)
    s1 = rng.uniform(-25, 0, (h, w, 2)).astype(np.float32)
    return s2, s1


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    jmcfg = JModelConfig(pretrained=False, fused_head=False)
    jparams, jconsts = j_init(jax.random.PRNGKey(0), jmcfg)
    params, consts = from_jax(*jax.tree.map(np.asarray, (jparams, jconsts)))
    return jmcfg, jparams, jconsts, params, consts


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, model):
    """The two-rank results of spatial_suite: frames, and a region's
    whole-frame ensemble over (2, 1) and (1, 2) ranks."""
    _, jparams, jconsts, _, _ = model
    root = tmp_path_factory.mktemp("spatial_ranks")
    save_popcorn_checkpoint(str(root / "model.pth"), jparams, jconsts)
    for name, (h, w, seed) in FRAMES.items():
        s2, s1 = _frame(h, w, seed)
        np.savez(str(root / f"frame_{name}.npz"), s2=s2, s1=s1)
    members = []
    for s in range(2):
        members.append(str(root / f"m{s}.pth"))
        save_popcorn_checkpoint(members[-1], jax.tree.map(lambda a: a * (1.0 + 0.01 * s), jparams),
                                jconsts)
    j_make(str(root / "region"), "rwa", height=192, width=256, seed=5)
    with open(root / "spec.json", "w") as f:
        json.dump({"model": str(root / "model.pth"), "frames": FRAMES, "members": members,
                   "region": str(root / "region")}, f)
    spawn_ranks(spatial_suite, 2, (str(root),), devices=CPU2)
    return root, torch.load(str(root / "spatial.pt"), weights_only=False)


def _jax_density(jparams, jconsts, jmcfg, s2, s1, mh):
    """The JAX single-device density of the frame padded to (mh, 32)."""
    s2p, _ = jsp._pad_frame(s2, mh, 32)
    s1p, _ = jsp._pad_frame(s1, mh, 32)
    x = j_normalize({"S2": jnp.asarray(s2p[None]), "S1": jnp.asarray(s1p[None])}, JNormStats())
    out = j_forward(jparams, jconsts, {"input": x}, jmcfg, train=False, padding=False, sparse=False)
    return np.asarray(out["popdensemap"])[0, :s2.shape[0], :s2.shape[1]]


def test_pad_frame_multiples_and_crop():
    a = np.arange(10 * 7 * 2, dtype=np.float32).reshape(10, 7, 2)
    p, (ph, pw) = sp._pad_frame(a, 8, 4)
    rp, rpads = jsp._pad_frame(a, 8, 4)
    assert p.shape == (16, 8, 2) and (ph, pw) == (6, 1) == rpads
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(p[10:, :7], np.broadcast_to(a[-1:], (6, 7, 2)))
    b = a[:8, :4]
    p2, pads = sp._pad_frame(b, 8, 4)
    assert pads == (0, 0) and p2 is b


def test_spatial_density_matches_single_device(model, two_ranks):
    """tests/test_spatial.py::test_spatial_density_matches_single_device:
    one rank and two ranks against the JAX whole frame on its 8-device mesh
    and on one device."""
    jmcfg, jparams, jconsts, params, consts = model
    h, w, seed = FRAMES["a"]
    s2, s1 = _frame(h, w, seed)
    ref, ref_cnt = jsp.spatial_density_map(jparams, jconsts, jmcfg, s2, s1, j_make_mesh(8))
    single = _jax_density(jparams, jconsts, jmcfg, s2, s1, 4)
    np.testing.assert_allclose(np.asarray(ref), single, **EXACT)
    for m, cnt in (sp.spatial_density_map(params, consts, MCFG, s2, s1, device="cpu"),
                   two_ranks[1]["density_a"]):
        assert m.shape == (h, w)
        np.testing.assert_allclose(m, single, **EXACT)
        np.testing.assert_allclose(cnt, ref_cnt, rtol=1e-5)


def test_spatial_density_padded_frame(model, two_ranks):
    """tests/test_spatial.py::test_spatial_density_padded_frame: rows not a
    multiple of 4 x n_data pad with edge values and crop; the map equals
    the JAX single-device forward of the frame padded the same way (one
    rank: to 4 rows, two ranks: to 8)."""
    jmcfg, jparams, jconsts, params, consts = model
    h, w, seed = FRAMES["pad"]
    s2, s1 = _frame(h, w, seed)
    for (m, cnt), mh in ((sp.spatial_density_map(params, consts, MCFG, s2, s1, device="cpu"), 4),
                         (two_ranks[1]["density_pad"], 8)):
        ref = _jax_density(jparams, jconsts, jmcfg, s2, s1, mh)
        assert m.shape == (h, w)
        np.testing.assert_allclose(m, ref, **EXACT)
        np.testing.assert_allclose(cnt, ref.sum(), rtol=1e-5)


def test_rank_blocks_hold_true_context(model, two_ranks):
    """Two ranks' row blocks of a frame taller than one block's window:
    each block computed with 64 rows of context beyond its edge equals the
    JAX single-device frame (the bound of the JAX package's strips)."""
    jmcfg, jparams, jconsts, _, _ = model
    h, w, seed = FRAMES["tall"]
    s2, s1 = _frame(h, w, seed)
    m, cnt = two_ranks[1]["density_tall"]
    ref = _jax_density(jparams, jconsts, jmcfg, s2, s1, 8)
    np.testing.assert_allclose(m, ref, **EXACT)
    np.testing.assert_allclose(cnt, ref.sum(), rtol=1e-5)
    x = j_normalize({"S2": jnp.asarray(s2[None]), "S1": jnp.asarray(s1[None])}, JNormStats())
    score = np.asarray(j_score(jconsts["builder"], x, s1=True, s2=True, nir=True, layout="plain"))[0]
    np.testing.assert_allclose(two_ranks[1]["builtup_tall"], score, **EXACT)


def test_spatial_builtup_matches_single_device(model, two_ranks):
    jmcfg, _, jconsts, _, consts = model
    h, w, seed = FRAMES["b"]
    s2, s1 = _frame(h, w, seed)
    x = j_normalize({"S2": jnp.asarray(s2[None]), "S1": jnp.asarray(s1[None])}, JNormStats())
    ref = np.asarray(j_score(jconsts["builder"], x, s1=True, s2=True, nir=True, layout="plain"))[0]
    np.testing.assert_allclose(
        np.asarray(jsp.spatial_builtup_map(jconsts, jmcfg, s2, s1, j_make_mesh(8))), ref, **EXACT)
    for got in (sp.spatial_builtup_map(consts, MCFG, s2, s1, device="cpu"),
                two_ranks[1]["builtup_b"]):
        np.testing.assert_allclose(got, ref, **EXACT)


def test_builtup_map_mesh_path_equals_patch_path(model, two_ranks):
    """builtup_map(mesh=) against the patch path on a frame that fits one
    patch, on one rank and two, and against the JAX mesh path."""
    jmcfg, _, jconsts, _, consts = model
    h, w, _ = FRAMES["b"]
    s2, s1 = _frame(h, w, seed=7)
    via_patch = builtup_map(consts, MCFG, s2, s1, patchsize=1024, device="cpu")
    via_mesh = builtup_map(consts, MCFG, s2, s1, mesh=make_mesh(devices=["cpu"]))
    np.testing.assert_allclose(via_mesh, via_patch, **PATCH_PATH)
    ref = np.asarray(j_builtup_map(jconsts, jmcfg, s2, s1, mesh=j_make_mesh(8)))
    np.testing.assert_allclose(via_mesh, ref, **PATCH_PATH)
    s2b, s1b = _frame(*FRAMES["b"])
    np.testing.assert_allclose(two_ranks[1]["ts_builtup_b"],
                               builtup_map(consts, MCFG, s2b, s1b, patchsize=1024, device="cpu"),
                               **PATCH_PATH)


def test_patch_stitch_zeroes_border_ring_spatial_fills_it(model):
    """The stitched path zeroes the frame's outer overlap ring (the
    reference's halo convention); the whole-frame path fills it, and the
    interiors agree."""
    _, _, _, _, consts = model
    h, w, ps, ov = 256, 256, 128, 32
    s2, s1 = _frame(h, w, seed=11)
    stitched = builtup_map(consts, MCFG, s2, s1, patchsize=ps, overlap=ov, device="cpu")
    exact = builtup_map(consts, MCFG, s2, s1, mesh=make_mesh(devices=["cpu"]))
    assert (stitched[:ov] == 0).all() and (stitched[:, :ov] == 0).all()
    assert (stitched[-ov:] == 0).all() and (stitched[:, -ov:] == 0).all()
    assert np.abs(exact[:ov]).max() > 0
    m = 2 * ov
    np.testing.assert_allclose(stitched[m:-m, m:-m], exact[m:-m, m:-m], **INTERIOR)


def test_spatial_fn_reuse_two_frames(model):
    _, _, _, _, consts = model
    fn = sp.make_spatial_builtup(consts, MCFG, None, device="cpu")
    for seed in (1, 2):
        s2, s1 = _frame(64, 64, seed=seed)
        out = sp.spatial_builtup_map(consts, MCFG, s2, s1, None, _fn=fn)
        assert out.shape == (64, 64) and np.isfinite(out).all()


def test_chunked_building_score_matches_whole_frame(model):
    """tests/test_spatial.py::test_chunked_building_score_matches_whole_frame,
    and the port's chunks against the JAX package's."""
    _, _, jconsts, _, consts = model
    h, w = 256, 64
    s2, s1 = _frame(h, w, seed=11)
    x = normalize_and_assemble({"S2": torch.from_numpy(s2[None]), "S1": torch.from_numpy(s1[None])},
                               NormStats())
    chunked = sp.chunked_building_score(consts, x, MCFG, None, rows_per_chunk=64).numpy()
    whole = create_building_score(consts["builder"], x, s1=True, s2=True, nir=True).numpy()
    np.testing.assert_allclose(chunked, whole, **EXACT)
    jx = j_normalize({"S2": jnp.asarray(s2[None]), "S1": jnp.asarray(s1[None])}, JNormStats())
    ref = jsp.chunked_building_score(jconsts, jx, dataclasses.replace(JModelConfig(pretrained=False),
                                                                       layout="spatial"),
                                     None, rows_per_chunk=64)
    np.testing.assert_allclose(chunked, np.asarray(ref), **EXACT)


def _fold(fold, members, sample, h, w):
    acc = sp.new_accumulators(h, w, device="cpu")
    return {k: v.numpy() for k, v in fold(members, sample, acc).items()}


def test_strip_fold_matches_whole_frame(model, monkeypatch):
    """tests/test_spatial.py::test_strip_fold_matches_whole_frame: the
    member fold in 64-row strips (and the builder in 64-row chunks) equals
    the whole-frame fold, which equals the JAX package's."""
    jmcfg, jparams, jconsts, params, consts = model
    jmembers, members = [], []
    for seed in (1, 2):
        m = dict(jparams)
        m["head"] = j_init_head(jax.random.PRNGKey(seed), biasinit=0.5)
        jmembers.append(m)
        members.append(from_jax(jax.tree.map(np.asarray, m), {})[0])
    h, w = 256, 64
    s2, s1 = _frame(h, w, seed=13)
    sample = {"S2": s2[None], "S1": s1[None]}
    whole = _fold(sp.make_spatial_ensemble(MCFG, consts, None, 2, device="cpu"), members, sample, h, w)
    jfold = jsp.make_spatial_ensemble(jmcfg, jconsts, JNormStats(), 2)
    jacc = {k: jnp.zeros((h, w), jnp.float32) for k in sp._ACC4}
    ref = jfold(stack_ensemble(jmembers), {"S2": jnp.asarray(s2[None]), "S1": jnp.asarray(s1[None])},
                jacc)
    monkeypatch.setattr(sp, "_MEMBER_CHUNK_MIN_H", 128)
    monkeypatch.setattr(sp, "_CHUNK_MIN_H", 128)
    strips = _fold(sp.make_spatial_ensemble(MCFG, consts, None, 2, device="cpu", strip_rows=64),
                   members, sample, h, w)
    for k in whole:
        np.testing.assert_allclose(strips[k], whole[k], err_msg=k, **EXACT)
        np.testing.assert_allclose(whole[k], np.asarray(ref[k]), err_msg=k, **INTERIOR)


def _region_maps(root, members, mcfg, spatial, patch=96, overlap=16, **kw):
    ds = PopulationDataset(DataPaths(str(root / "region")), "rwa", mode="test", patchsize=patch,
                           overlap=overlap, fourseasons=False)
    ps = [load_popcorn_checkpoint(p) for p in members]
    if spatial:
        out = sp.run_spatial_inference([p[0] for p in ps], ps[0][1], mcfg, ds,
                                       mesh=make_mesh(devices=["cpu"]), **kw)
    else:
        out = run_sliding_inference([p[0] for p in ps], ps[0][1], mcfg, ds, device="cpu", **kw)
    ds.close()
    return out


def test_run_spatial_inference_matches_jax(two_ranks):
    """The whole-region ensemble against the JAX package's on its 8-device
    mesh; over (2, 1) and (1, 2) ranks against one rank; the stitched
    eval's ring is 0 where the whole-frame maps hold output, and the
    interiors agree."""
    root, ranks = two_ranks
    spec = json.load(open(root / "spec.json"))
    from popcorn_tpu.infer.evaluator import load_member as j_load_member

    jm = [j_load_member(p) for p in spec["members"]]
    jds = JDataset(JDataPaths(spec["region"]), "rwa", mode="test", patchsize=96, overlap=16,
                   fourseasons=False)
    ref = jsp.run_spatial_inference([m[0] for m in jm], jm[0][1], JModelConfig(pretrained=False),
                                    jds, mesh=j_make_mesh(8))
    jds.close()
    one = _region_maps(root, spec["members"], MCFG, True)
    assert (one["count"] == 2).all()
    for k in ("map", "scale"):
        np.testing.assert_allclose(one[k], ref[k], err_msg=k, **INTERIOR)
    for grid in ("2x1", "1x2"):
        got = ranks[f"region_{grid}"]
        for k in ("map", "scale", "map_std", "scale_std"):
            np.testing.assert_allclose(got[k], one[k], err_msg=f"{grid} {k}", **EXACT)
    # the stitched eval with an overlap beyond the model's receptive field
    # (about 22 px, tests/test_spatial.py), where its interiors are exact
    ov = 32
    stitched = _region_maps(root, spec["members"], MCFG, False, patch=128, overlap=ov)
    assert (stitched["map"][:ov] == 0).all() and np.abs(one["map"][:ov]).max() > 0
    np.testing.assert_allclose(stitched["map"][2 * ov:-2 * ov, 2 * ov:-2 * ov],
                               one["map"][2 * ov:-2 * ov, 2 * ov:-2 * ov], **INTERIOR)


def test_eval_cli_spatial(two_ranks, tmp_path):
    """The eval CLI's --spatial (one rank, --device cpu): its GeoTIFF map is
    run_spatial_inference's, and it writes the five products."""
    root, _ = two_ranks
    spec = json.load(open(root / "spec.json"))
    cks = [str(tmp_path / os.path.basename(p)) for p in spec["members"]]
    for src, dst in zip(spec["members"], cks):
        with open(src, "rb") as a, open(dst, "wb") as b:
            b.write(a.read())
    timings = {}
    stats = eval_cli.main(["--data_root", spec["region"], "-treg", "rwa", "-S1", "-S2", "-NIR",
                           "-occmodel", "-senbuilds", "--compute_dtype", "float32", "--spatial",
                           "--patchsize", "96", "--patch_overlap", "16", "--device", "cpu",
                           "-r", *cks], timings=timings)
    assert any(k.startswith("Population_MainCensus_rwa") for k in stats)
    t = timings["rwa"]
    assert t["n_seasons"] == 1 and t["fold_s"] > 0
    assert t["feed_wait_s"] + t["fold_s"] + t["finalize_s"] <= t["total_s"] + 1e-6
    (out_dir,) = [d for d in os.listdir(tmp_path) if d.startswith("eval_outputs_ensemble")]
    with GeoTIFF(os.path.join(tmp_path, out_dir, "rwa_predictions.tif")) as g:
        got = g.read(1, squeeze=True)
    ref = _region_maps(root, spec["members"], ModelConfig(sentinel_buildings=True), True)
    np.testing.assert_allclose(got, ref["map"], **EXACT)
    assert len([f for f in os.listdir(os.path.join(tmp_path, out_dir)) if f.endswith(".tif")]) == 5
