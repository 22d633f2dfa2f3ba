"""The port stands alone: every module of popcorn_tpu_torch imports with
jax, ml_dtypes, optax, orbax and popcorn_tpu made unimportable, and no
file of the package (nor chip_smoke.py) imports any of them (the machine
with the card has none of them); the time-series, DDA, rank-layer,
whole-frame, geo, acquisition and dry-run modules import no pandas or
matplotlib either; matplotlib is imported only inside utils/viz.py's
functions; and importing the rank layer (dist/) and infer/spatial.py
starts no process group."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "popcorn_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "optax", "orbax", "popcorn_tpu")
# modules that also import neither pandas nor a plotting library: the time
# series and DDA training write their tables with the csv module
NO_PANDAS = ("dda/datasets.py", "dda/losses.py", "dda/metrics.py", "dda/network.py",
             "dda/train.py", "infer/timeseries.py", "infer/pop_timeseries.py",
             "cli/timeseries.py", "cli/dda_train.py", "dist/mesh.py", "dist/launch.py",
             "dist/multihost.py", "dist/rows.py", "infer/spatial.py", "utils/flops.py",
             "utils/profiling.py", "geo/shapefile.py", "geo/rasterize.py", "acquisition/common.py",
             "acquisition/gee.py", "acquisition/mpc.py", "acquisition/sentinel_hub.py",
             "dryrun.py")
# the one module that may import matplotlib, inside its functions only
PLOTS = "utils/viz.py"


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_package_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", NO_PANDAS)
def test_no_pandas_or_matplotlib_import(rel):
    bad = sorted(set(_imported_roots(os.path.join(PKG, rel))) & {*FORBIDDEN, "pandas", "matplotlib"})
    assert not bad, f"{rel} imports {bad}"


def test_matplotlib_only_inside_the_plot_functions():
    """No module imports matplotlib at its top level, and only utils/viz.py
    imports it at all, inside its functions: the port imports without it
    (the card's installation has none)."""
    for path in _sources():
        tree = ast.parse(open(path).read(), filename=path)
        top = {n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            if any(n.split(".")[0] == "matplotlib" for n in names):
                rel = os.path.relpath(path, PKG)
                assert rel == PLOTS and node not in top, f"{rel} imports matplotlib at line {node.lineno}"


def test_every_module_imports_without_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in FORBIDDEN:
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import popcorn_tpu_torch
        n = 0
        for m in pkgutil.walk_packages(popcorn_tpu_torch.__path__, "popcorn_tpu_torch."):
            importlib.import_module(m.name)
            n += 1
        assert not [k for k in sys.modules if k.split(".")[0] in FORBIDDEN]
        print(n)
        """
    ).replace("FORBIDDEN", repr(FORBIDDEN))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


def test_rank_layer_import_starts_no_process_group():
    """dist/mesh.py, dist/launch.py, dist/multihost.py, dist/rows.py and
    infer/spatial.py import without jax and leave torch.distributed uninitialised: ranks
    join a group only through init_distributed (or the CLIs' spawn)."""
    code = textwrap.dedent(
        """
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in FORBIDDEN:
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import torch.distributed as dist
        import popcorn_tpu_torch.dist.launch
        import popcorn_tpu_torch.dist.mesh as mesh
        import popcorn_tpu_torch.dist.multihost
        import popcorn_tpu_torch.dist.rows
        import popcorn_tpu_torch.infer.spatial
        assert not dist.is_initialized()
        m = mesh.make_mesh(devices=["cpu"])
        assert (m.size, m.backend) == (1, None) and not dist.is_initialized()
        print("ok")
        """
    ).replace("FORBIDDEN", repr(FORBIDDEN))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
