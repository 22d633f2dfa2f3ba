"""Local ranks for a command typed without torchrun.

``python -m popcorn_tpu_torch.cli.train --data_parallel N`` (and the eval
CLI's ``--data_parallel``/``--ensemble_parallel``) spawn their N ranks on
this host with ``torch.multiprocessing`` (the ``spawn`` start method),
one a card, or one a CPU process under ``--device cpu``. Each rank gets
torchrun's environment (a localhost address on a free port), joins the
group through ``dist/mesh.py::init_distributed`` and runs the entry
point. A rank's failure raises in the parent, which the command then
exits with. The same command under ``torchrun`` finds WORLD_SIZE set and
does not spawn.
"""

from __future__ import annotations

import os
import socket
from typing import Callable, Optional, Sequence


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def under_launcher() -> bool:
    """Whether this process is one rank of a launched group (torchrun or
    spawn_ranks)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def _rank_entry(local_rank: int, fn: Callable, nprocs: int, port: int, args: tuple,
                devices: Optional[Sequence[str]]) -> None:
    import torch.distributed as dist

    from . import mesh as mesh_mod

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(local_rank),
                      LOCAL_RANK=str(local_rank), WORLD_SIZE=str(nprocs),
                      LOCAL_WORLD_SIZE=str(nprocs))
    mesh_mod.init_distributed(devices)
    try:
        fn(*args)
    finally:
        mesh_mod._GROUPS.clear()
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, nprocs: int, args: tuple = (),
                devices: Optional[Sequence[str]] = None) -> None:
    """Run ``fn(*args)`` in ``nprocs`` spawned local ranks of one process
    group (``devices``: one a rank, as ``dist/mesh.py::rank_devices``
    takes them; None for one card a rank, which raises in every rank on a
    host without enough cards). ``fn`` must be importable by name (a
    module-level function).
    Raises when any rank fails."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_entry, args=(fn, nprocs, free_port(), args,
                                          None if devices is None else list(devices)),
                       nprocs=nprocs, join=True, start_method="spawn")

