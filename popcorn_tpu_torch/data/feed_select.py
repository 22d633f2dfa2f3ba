"""Measured cost gate for the training feed's choice.

Counterpart of popcorn_tpu/data/feed_select.py. The trainer's feed chain
is full-resident device feed -> season-rotating device feed -> host feed.
Full residency, when it fits, is fastest (one upload for the whole run).
Rotation against the host feed is a real trade: the rotating feed
re-uploads every season's S2/S1 slice once per epoch, a FIXED cost per
epoch of ``swap_bytes / link_rate``, while the host feed's cost scales
with the number of samples. Small epochs sit on the host side of the
crossover; country-scale epochs (thousands of admin regions, the
reference run_train.py:431's DataLoader over the full census table) far
past it.

* :func:`measure_link_bytes_per_s` — one timed pinned host-to-device copy
  of the actual link rate.
* :func:`measure_host_items_per_s` — times a couple of real host-feed item
  fetches (windowed raster read + NaN healing + assembly, the per-step
  cost the reference pays in its DataLoader workers) and adds the
  per-sample upload at the measured link rate.
* :func:`prefer_rotation` — the pure decision function, tested on both
  sides of the crossover (tests/test_torch_feed_select.py).

Environment overrides (tests and operators):

* ``POPCORN_FEED_GATE=off``  — skip the gate: rotation whenever it fits.
* ``POPCORN_FEED_GATE=host`` — force the host side.
* ``POPCORN_FEED_GATE_LINK_MBPS`` / ``POPCORN_FEED_GATE_HOST_SPS`` —
  inject measured rates instead of probing.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FeedGateInputs:
    """Everything the rotation-vs-host decision depends on.

    ``host_items_per_s`` must already include the host feed's own
    per-sample upload cost; ``dev_items_per_s`` is the rotating feed's
    steady assembly rate BETWEEN swaps (on-device crops; the conservative
    default keeps the gate from flattering rotation)."""

    n_samples: int
    swap_bytes: int
    link_bytes_per_s: float
    host_items_per_s: float
    dev_items_per_s: float = 40.0

    def rotation_epoch_s(self) -> float:
        """Per-epoch cost of the rotating feed: every seasonal slice
        uploads once per epoch (device_weaksup._epoch_batches is
        season-major), then samples assemble on the device. Prefetch can
        hide part of a swap under the previous season's compute, but at
        the epoch sizes where the gate matters there is little compute to
        hide under — counted in full (conservative toward the host feed,
        the side that loses nothing when wrong)."""
        return self.swap_bytes / max(self.link_bytes_per_s, 1e-6) + (
            self.n_samples / max(self.dev_items_per_s, 1e-6)
        )

    def host_epoch_s(self) -> float:
        return self.n_samples / max(self.host_items_per_s, 1e-9)


def prefer_rotation(g: FeedGateInputs) -> bool:
    """True when the rotating device feed's estimated epoch is faster
    than the host feed's. Pure function of measured inputs."""
    return g.rotation_epoch_s() < g.host_epoch_s()


def gate_report(g: FeedGateInputs) -> str:
    return (
        f"rotation {g.rotation_epoch_s():.1f}s/epoch "
        f"({g.swap_bytes / 1e6:.0f} MB swaps @ "
        f"{g.link_bytes_per_s / 1e6:.1f} MB/s) vs host "
        f"{g.host_epoch_s():.1f}s/epoch "
        f"({g.n_samples} samples @ {g.host_items_per_s:.2f}/s)"
    )


# -- probes -------------------------------------------------------------------

_link_cache: dict = {}


def measure_link_bytes_per_s(device="cuda", nbytes: int = 16 << 20) -> float:
    """Host-to-device rate from one timed copy of ``nbytes`` from pinned
    memory, ended by ``torch.cuda.synchronize`` (a plain host copy when
    ``device`` is the CPU). Cached per process and device."""
    ov = os.environ.get("POPCORN_FEED_GATE_LINK_MBPS")
    if ov:
        return float(ov) * 1e6
    device = torch.device(device)
    key = (str(device), nbytes)
    if key in _link_cache:
        return _link_cache[key]
    a = torch.from_numpy(np.random.default_rng(0).random(nbytes // 4).astype(np.float32))
    if device.type == "cuda":
        a = a.pin_memory()
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    b = a.to(device, non_blocking=True) if device.type == "cuda" else a.clone()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rate = nbytes / max(time.perf_counter() - t0, 1e-9)
    del b
    _link_cache[key] = rate
    return rate


def measure_host_items_per_s(
    feed,
    *,
    link_bytes_per_s: float,
    n_probe: int = 2,
    epoch: int = 0,
) -> float:
    """Measured host-feed sample rate: times ``n_probe`` real item
    fetches through the feed's own hook (windowed read + healing +
    assembly — the exact epoch-0 items, so the probe work is a prefix of
    work the host feed would redo anyway), scales by the fetch
    parallelism actually available (num_workers threads, bounded by host
    cores — the reference's DataLoader workers, run_train.py:431), and
    adds the per-sample transport bytes at the measured link rate."""
    ov = os.environ.get("POPCORN_FEED_GATE_HOST_SPS")
    if ov:
        return float(ov)
    rng = np.random.default_rng(feed.seed + 1000 * epoch)
    order = rng.permutation(len(feed.index))[:n_probe]
    t0 = time.perf_counter()
    items = [feed._fetch_item(int(j), epoch) for j in order]
    items = [it for it in items if it is not None]
    fetch_s = max(time.perf_counter() - t0, 1e-9) / max(len(items), 1)
    workers = max(1, min(feed.num_workers, os.cpu_count() or 1))
    item_bytes = max(
        (sum(a.nbytes for a in it.values() if isinstance(a, np.ndarray)) for it in items),
        default=0,
    )
    per_item_s = fetch_s / workers + item_bytes / max(link_bytes_per_s, 1e-6)
    return 1.0 / max(per_item_s, 1e-9)


def gate_mode() -> str:
    """'auto' (measure + decide), 'off' (rotation when it fits), or
    'host' (forced host side)."""
    return os.environ.get("POPCORN_FEED_GATE", "auto")


def gather_gate_inputs(
    feed,
    *,
    n_samples: int,
    swap_bytes: int,
    device="cuda",
) -> FeedGateInputs:
    """Run both probes and assemble :class:`FeedGateInputs`."""
    link = measure_link_bytes_per_s(device)
    host_sps = measure_host_items_per_s(feed, link_bytes_per_s=link)
    return FeedGateInputs(
        n_samples=n_samples,
        swap_bytes=swap_bytes,
        link_bytes_per_s=link,
        host_items_per_s=host_sps,
    )
