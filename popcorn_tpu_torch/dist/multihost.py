"""The multi-process rehearsal: worker and launcher.

Counterpart of popcorn_tpu/dist/multihost.py. ``--multihost`` and the
ranked paths need more than one process to exist; this module runs them
for real on one machine:

  * ``worker_main`` — one localhost rank: joins a gloo group with every
    worker on one card (``--device``, default cuda:0: ranks that share a
    card, which NCCL would refuse; ``--device cpu`` for CPU ranks, as the
    tests run it), builds the multi-host grid, runs ONE deterministic
    data-parallel train step and the 2-way ensemble fold over 3 members,
    and prints the loss, the gathered popcount sum and the fold's sum;
  * ``launch_workers`` — spawns the workers and collects their results;
    any worker's failure raises with every worker's output attached.

The workload is the JAX module's ``demo_batch`` (8 samples of 64^2, seed
0) and members scaled by 1 + 0.01 s, so a run compares with the
single-process step (``run_demo_step(None)``) and fold
(``run_demo_eval(None)``). The model is random, from seed 0, or the
(params, consts, mask) of ``--state`` (a ``torch.save`` file) — the JAX
package's weights and its drawn sparsity mask, for a parity check. The
head is fused, so each rank's step runs kernels A-D on the card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_B, _H, _W = 8, 64, 64
BATCH_KEYS = ("S2", "S1", "admin_mask", "census_idx", "y")


def demo_batch() -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    ids = np.tile(np.arange(1, _B + 1, dtype=np.float32)[:, None, None], (1, _H, _W))
    return {
        "S2": rng.uniform(0, 4000, (_B, _H, _W, 4)).astype(np.float32),
        "S1": rng.uniform(-25, 0, (_B, _H, _W, 2)).astype(np.float32),
        "admin_mask": ids,
        "census_idx": np.arange(1, _B + 1, dtype=np.float32),
        "y": rng.uniform(10, 1000, (_B,)).astype(np.float32),
        "photometric": np.asarray([0.0, 1.0, 0.0, 1.0], np.float32),
    }


def _demo_state(state: Optional[str]):
    """(params, consts, mask or None): ``state``'s, else seed 0's."""
    from ..config import ModelConfig
    from ..nn.init import init_popcorn

    if state is None:
        params, consts = init_popcorn(0, ModelConfig(pretrained=False))
        return params, consts, None
    s = torch.load(state)
    return s["params"], s["consts"], s.get("mask")


def run_demo_step(mesh=None, state: Optional[str] = None, device="cuda"):
    """One data-parallel train step of the demo workload on ``mesh`` (None:
    ``device``, the card unless the caller asks for the CPU). Returns (loss, popcount sum, new params); the popcounts
    are gathered from every data rank (``fetch_to_host``)."""
    from ..compat.weights import to_torch
    from ..config import ModelConfig, TrainConfig
    from ..data.normalize import NormStats
    from ..train.state import make_optimizer, make_train_step
    from .mesh import fetch_to_host, replicate, resolve_device, shard_batch

    dev = resolve_device(mesh.device if mesh is not None else device)
    mcfg = ModelConfig(pretrained=False)
    tcfg = TrainConfig(weak_batch_size=_B)
    params, consts, mask = _demo_state(state)
    params = replicate(to_torch(params, dev), mesh)
    consts = replicate(to_torch(consts, dev), mesh)
    optimizer = make_optimizer(tcfg)
    step = make_train_step(mcfg, tcfg, consts, NormStats(device=dev), optimizer, mesh=mesh)
    batch = shard_batch(demo_batch(), mesh, batch_keys=BATCH_KEYS)
    dev_batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
    if mask is not None and mesh is not None:
        mask = mask[torch.as_tensor(mesh.batch_rows(_B))]
    new_params, _, aux = step(params, optimizer.init(params), dev_batch,
                              torch.Generator().manual_seed(7),
                              mask=None if mask is None else mask.to(dev))
    loss = float(aux["optimization_loss"])
    pop_sum = float(fetch_to_host(aux["popcount"], mesh).sum())
    return loss, pop_sum, new_params


def run_demo_eval(mesh=None, state: Optional[str] = None, device="cuda") -> float:
    """The Bag-of-POPCORN patch fold of 3 members (params scaled by
    1 + 0.01 s) over ``mesh``: the patches (one a data rank) split over
    'data', the members over 'ensemble'. Returns the total of the global
    dense_sum map, the same on every rank."""
    from ..compat.weights import to_torch
    from ..config import ModelConfig
    from ..data.normalize import NormStats
    from ..infer.sliding import make_patch_forward
    from .mesh import resolve_device

    dev = resolve_device(mesh.device if mesh is not None else device)
    params, consts, _ = _demo_state(state)
    params, consts = to_torch(params, dev), to_torch(consts, dev)
    members = [scaled_tree(params, 1.0 + 0.01 * s) for s in range(3)]
    nd = 1 if mesh is None else mesh.n_data
    ne = 1 if mesh is None else mesh.n_ensemble
    rng = np.random.default_rng(0)
    s2 = rng.uniform(0, 4000, (nd, _H, _W, 4)).astype(np.float32)
    s1 = rng.uniform(-25, 0, (nd, _H, _W, 2)).astype(np.float32)
    d = 0 if mesh is None else mesh.data_index
    e = 0 if mesh is None else mesh.ensemble_index
    per = -(-len(members) // ne)
    local = members[e * per:(e + 1) * per]  # padded slots hold no member
    batch = {"S2": torch.from_numpy(s2[d:d + 1]).to(dev), "S1": torch.from_numpy(s1[d:d + 1]).to(dev),
             "mask": torch.ones((1, _H, _W), device=dev), "valid": torch.ones(1, dtype=torch.bool, device=dev)}
    fwd = make_patch_forward(ModelConfig(pretrained=False), consts, NormStats(device=dev), len(local))
    dense = fwd(local, batch)["dense_sum"] if local else torch.zeros((1, _H, _W), device=dev)
    if mesh is not None:
        mesh.all_reduce(dense, "ensemble")
        dense = mesh.all_gather(dense, "data")
    return float(dense.double().sum())


def scaled_tree(tree, f: float):
    """Every leaf of a parameter tree times ``f`` (the demo's and the
    parity selftest's ensemble members: params scaled by 1 + 0.01 s)."""
    if isinstance(tree, dict):
        return {k: scaled_tree(v, f) for k, v in tree.items()}
    return tree * f


def worker_main(argv=None) -> None:
    import argparse

    import torch.distributed as dist

    from ..utils.profiling import COUNTERS
    from .mesh import init_distributed, make_multihost_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="HOST:PORT of rank 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", default="cuda:0",
                    help="every worker's device: one card (default cuda:0; raises "
                         "without one) or 'cpu'")
    ap.add_argument("--state", default=None, help="torch.save'd {params, consts, mask}")
    ap.add_argument("--out", default=None, help="rank 0 writes the stepped params here")
    a = ap.parse_args(argv)

    host, port = a.coordinator.rsplit(":", 1)
    n = a.num_processes
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=str(a.process_id),
                      WORLD_SIZE=str(n), LOCAL_RANK=str(a.process_id), LOCAL_WORLD_SIZE=str(n))
    init_distributed([a.device] * n)
    try:
        mesh = make_multihost_mesh(n_data_per_host=n, devices=[a.device] * n)
        assert mesh.n_data == n, mesh
        before = COUNTERS.summary()
        loss, pop_sum, params = run_demo_step(mesh, a.state)
        launches = COUNTERS.since(before, "launches/")
        ens_mesh = make_multihost_mesh(n_data_per_host=1, n_ensemble=n, devices=[a.device] * n)
        ens_sum = run_demo_eval(ens_mesh, a.state)
        if a.out is not None and mesh.is_root:
            torch.save({k: v.cpu() for k, v in flat_tree(params).items()}, a.out)
        print(f"MULTIHOST_OK pid={a.process_id} loss={loss!r} popsum={pop_sum!r} "
              f"enssum={ens_sum!r} launches={json.dumps(launches)}", flush=True)
    finally:
        dist.destroy_process_group()


def flat_tree(tree, prefix="") -> Dict[str, torch.Tensor]:
    """A parameter tree as {'a.b.c': leaf}."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def launch_workers(
    num_processes: int = 2,
    timeout: float = 900.0,
    device: str = "cuda:0",
    state: Optional[str] = None,
    out: Optional[str] = None,
    launches: Optional[list] = None,
) -> List[Tuple[float, float, float]]:
    """Spawn localhost workers; return [(loss, popsum, enssum), ...] by
    process id (and append each worker's kernel launches of its step, its
    ``launches/<entry>`` counters, to ``launches``). Raises on any worker's
    failure (or a missing result line), with every worker's output
    attached."""
    from .launch import free_port

    coordinator = f"127.0.0.1:{free_port()}"
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for pid in range(num_processes):
        cmd = [sys.executable, "-m", "popcorn_tpu_torch.dist.multihost",
               "--coordinator", coordinator, "--num-processes", str(num_processes),
               "--process-id", str(pid), "--device", device]
        if state is not None:
            cmd += ["--state", state]
        if out is not None:
            cmd += ["--out", out]
        procs.append(subprocess.Popen(cmd, cwd=repo_root, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            outs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    report = "\n".join(f"--- worker {i} (rc={rc}) ---\n{o}\n{e}" for i, (rc, o, e) in enumerate(outs))
    results = []
    for rc, o, _ in outs:
        m = re.search(r"MULTIHOST_OK pid=\d+ loss=(\S+) popsum=(\S+) enssum=(\S+) launches=(.*)", o)
        if rc != 0 or not m:
            raise RuntimeError(f"multihost worker failed:\n{report}")
        results.append((float(m.group(1)), float(m.group(2)), float(m.group(3))))
        if launches is not None:
            launches.append(json.loads(m.group(4)))
    return results


if __name__ == "__main__":
    worker_main()
