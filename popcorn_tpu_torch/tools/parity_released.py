"""Push-button R² parity harness for the released POPCORN checkpoints.

The north-star acceptance test (BASELINE.md:27-29): evaluate the released
5-member Bag-of-POPCORN (reference README.md:200, seeds 1600-1604) with
the port and compare the census-level metrics against the reference's
published numbers. Counterpart of tools/parity_released.py, with
``--device`` (the card unless the caller asks for the CPU):

  python -m popcorn_tpu_torch.tools.parity_released -r m1.pth m2.pth m3.pth \\
      m4.pth m5.pth --data_root /data/PopMapData --region rwa --fourseasons \\
      --expected expected_rwa.json

``--expected`` is a JSON object {metric_name: value} (e.g.
{"Population_MainCensus_rwa_fine/r2": 0.66}); the harness prints a diff
table and exits non-zero if any |ours - expected| > --rtol * |expected|.
Without --expected it prints our metrics for manual comparison with the
paper (arXiv:2311.14006 — the repo publishes no machine-readable table,
SURVEY.md §6).

``--selftest`` runs the whole path offline: it builds a synthetic
192x256 region and a 5-member .pth quintet (compat/weights.py::
save_popcorn_checkpoint), evaluates it through the stitched, ``--spatial``,
``--quantize int8s`` and ``--transport bf16`` surfaces, and checks that
the eval CLI (cli/eval.py) given the harness's model flags returns the
same metrics as the harness. Its last line is one JSON object with each
surface's metrics and kernel launches.
"""

import argparse
import json
import os
import sys

import numpy as np

# the canonical README eval config (reference README.md:167-173), as the
# eval CLI's flags: the harness's model config is the CLI's for these
MODEL_FLAGS = ("-S1", "-S2", "-NIR", "-occmodel", "-senbuilds", "-binit", "0.75",
               "--compute_dtype", "float32")


def evaluate(checkpoints, data_root, region, train_level, fourseasons,
             patch_batch=1, paths=None, patchsize=2048, overlap=128,
             spatial=False, quantize=None, transport="exact", device="cuda"):
    from ..cli.args import model_config_from_args
    from ..config import DataPaths, EvalConfig
    from ..infer.evaluator import Evaluator

    ns = argparse.Namespace(
        Sentinel1=True, Sentinel2=True, NIR=True, VIIRS=False,
        occupancymodel=True, pretrained=False, biasinit=0.75,
        sentinelbuildings=True, buildinginput=False, segmentationinput=False,
        feature_extractor="DDA", compute_dtype="float32", fused_head=None,
        quantize=quantize,
    )
    mcfg = model_config_from_args(ns)
    ecfg = EvalConfig(
        target_regions=(region,), train_level=(train_level,),
        checkpoints=tuple(checkpoints), fourseasons=fourseasons,
        patch_batch=patch_batch, patchsize=patchsize, overlap=overlap,
        spatial=spatial, transport=transport,
    )
    if paths is None:
        paths = DataPaths(data_root)
    ev = Evaluator(paths, mcfg, ecfg, device=device)
    return ev.test_target(save=True)


def diff_expected(ours, expected, rtol):
    rows, failed = [], False
    for k, want in sorted(expected.items()):
        got = ours.get(k)
        if got is None:
            rows.append((k, want, None, "MISSING"))
            failed = True
            continue
        ok = abs(got - want) <= rtol * max(abs(want), 1e-12)
        rows.append((k, want, got, "ok" if ok else "FAIL"))
        failed |= not ok
    w = max(len(r[0]) for r in rows) if rows else 10
    print(f"{'metric':<{w}}  {'expected':>10}  {'ours':>10}  verdict")
    for k, want, got, verdict in rows:
        g = f"{got:.4f}" if got is not None else "—"
        print(f"{k:<{w}}  {want:>10.4f}  {g:>10}  {verdict}")
    return failed


def selftest(device="cuda") -> dict:
    """Build a region and a .pth quintet, run every surface of the harness
    on ``device``; returns {surface: {"n_metrics", "r2", "launches"}} and
    the CLI check. Raises AssertionError when a surface's metrics are missing or
    not finite, or the CLI's differ from the harness's."""
    import tempfile

    from ..cli import eval as eval_cli
    from ..compat.weights import save_popcorn_checkpoint
    from ..config import ModelConfig
    from ..data.synthetic import make_synthetic_region
    from ..dist.mesh import resolve_device
    from ..dist.multihost import scaled_tree
    from ..nn.init import init_popcorn
    from ..utils.profiling import COUNTERS

    device = str(resolve_device(device))
    out = {}
    with tempfile.TemporaryDirectory() as td:
        data = os.path.join(td, "data")
        paths = make_synthetic_region(data, "rwa", height=192, width=256, seed=31)
        params, consts = init_popcorn(1600, ModelConfig(pretrained=False))
        members = []
        for s in range(5):
            p = os.path.join(td, f"m{s + 1}.pth")
            # the members differ in their parameters; the BN constants stay
            save_popcorn_checkpoint(p, scaled_tree(params, 1.0 + 0.01 * s), consts,
                                    epoch=s, iteration=s)
            members.append(p)

        # the stitched eval, then the --spatial surface (whole frame: the
        # border ring the stitched map zeroes holds true output, so its
        # metrics differ from the stitched ones), the static int8 kernels
        # (--quantize int8s: parity with float32 is bounded, not exact) and
        # --transport bf16 (lossy by construction)
        for surface, kw in (("stitched", {}), ("spatial", {"spatial": True}),
                            ("int8s", {"quantize": "int8s"}), ("transport_bf16", {"transport": "bf16"})):
            before = COUNTERS.summary()
            ours = evaluate(members, None, "rwa", "coarse", fourseasons=False, paths=paths,
                            patchsize=96, overlap=16, device=device, **kw)
            if surface == "stitched":
                ours_stitched = ours
            r2 = {k: v for k, v in ours.items() if k.endswith("/r2")}
            if not r2 or not all(np.isfinite(v) for v in ours.values()):
                raise AssertionError(f"{surface}: no r2 metric, or one not finite: {ours}")
            for k in sorted(r2):
                print(f"  [{surface}] {k}: {r2[k]:.4f}")
            print(f"selftest OK: {surface} surface produced {len(ours)} finite metrics")
            out[surface] = {"n_metrics": len(ours), "r2": r2,
                            "launches": COUNTERS.since(before, "launches/")}

        # the eval CLI with the harness's model flags: the same members,
        # region and patches give the same metrics
        cli_stats = eval_cli.main(["--data_root", data, *MODEL_FLAGS, "-treg", "rwa",
                                   "-tlevel", "coarse", "--patchsize", "96",
                                   "--patch_overlap", "16", "--device", device, "-r", *members])
        cli_equal = cli_stats == ours_stitched
        if not cli_equal:
            raise AssertionError(f"the eval CLI's metrics {cli_stats} differ from the harness's "
                                 f"{ours_stitched}")
        print(f"selftest OK: the eval CLI's {len(cli_stats)} metrics equal the harness's")
        out["cli_equals_harness"] = cli_equal
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-r", "--checkpoints", nargs="+",
                    help="released .pth members (m1..m5)")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--region", default="rwa")
    ap.add_argument("--train_level", default="coarse")
    ap.add_argument("-fs", "--fourseasons", action="store_true")
    ap.add_argument("--patch_batch", type=int, default=1)
    ap.add_argument("--spatial", action="store_true",
                    help="whole-region spatially-partitioned inference")
    ap.add_argument("--quantize", default=None, choices=("int8", "int8s"),
                    help="quantized member fold (parity bound is looser "
                    "by construction)")
    ap.add_argument("--transport", default="exact", choices=("exact", "bf16"),
                    help="data-plane dtype for float image modalities "
                    "(bf16: half the upload bytes; lossy)")
    ap.add_argument("--expected", default=None,
                    help="JSON file {metric: expected_value}")
    ap.add_argument("--rtol", type=float, default=1e-3,
                    help="relative tolerance vs expected (BASELINE.json)")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or 'cpu' for the plain versions")
    a = ap.parse_args(argv)

    if a.selftest:
        print(json.dumps({"selftest": selftest(a.device)}), flush=True)
        return
    if not a.checkpoints:
        ap.error("-r/--checkpoints required (or --selftest)")
    ours = evaluate(
        a.checkpoints, a.data_root, a.region, a.train_level,
        a.fourseasons, a.patch_batch, spatial=a.spatial, quantize=a.quantize,
        transport=a.transport, device=a.device,
    )
    for k in sorted(ours):
        print(f"  {k}: {ours[k]:.4f}")
    if a.expected:
        with open(a.expected) as f:
            expected = json.load(f)
        if diff_expected(ours, expected, a.rtol):
            sys.exit(1)
        print("PARITY OK")


if __name__ == "__main__":
    main()
