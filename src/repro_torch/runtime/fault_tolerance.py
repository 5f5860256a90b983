"""Fault tolerance and elasticity for the training runtime.

Counterpart of ``repro.runtime.fault_tolerance``, a copy (numpy only).
Three mechanisms, simulated in one process as the reference's are:

1. **Heartbeat / failure detection**: ``HealthMonitor`` tracks per-host
   step latencies; a host is `failed` when it misses `timeout` seconds,
   a straggler when its latency exceeds `straggler_factor` x the fleet
   median.

2. **Elastic re-meshing**: on a failure the failed hosts' data shards are
   dropped and the caller restores the latest checkpoint.  On one card
   the re-mesh is this bookkeeping and the checkpoint rewind (the data
   pipeline is a pure function of (step, shard), so no data is lost or
   duplicated).  The train loop restores a ZeRO-1 checkpoint onto another
   DP size (``train.loop``'s ``restore_shardings``); re-meshing the live
   process groups of a multi-rank run is not ported (the reference's is
   this bookkeeping too).

3. **Straggler mitigation**: a slow host's data shard is re-assigned
   round-robin to healthy hosts for the next step (`reassign_shards`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class HostStatus:
    last_beat: float
    latencies: List[float] = dataclasses.field(default_factory=list)
    failed: bool = False


class HealthMonitor:
    def __init__(self, hosts: List[int], timeout: float = 60.0,
                 straggler_factor: float = 2.0, now=time.monotonic):
        self._now = now
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self.hosts: Dict[int, HostStatus] = {
            h: HostStatus(last_beat=now()) for h in hosts}

    def beat(self, host: int, step_latency: Optional[float] = None):
        st = self.hosts[host]
        st.last_beat = self._now()
        if step_latency is not None:
            st.latencies.append(step_latency)
            st.latencies = st.latencies[-16:]

    def failed_hosts(self) -> List[int]:
        t = self._now()
        out = []
        for h, st in self.hosts.items():
            if st.failed or (t - st.last_beat) > self.timeout:
                st.failed = True
                out.append(h)
        return out

    def stragglers(self) -> List[int]:
        med = np.median([np.mean(st.latencies) for st in self.hosts.values()
                         if st.latencies and not st.failed] or [0.0])
        if med <= 0:
            return []
        return [h for h, st in self.hosts.items()
                if st.latencies and not st.failed
                and np.mean(st.latencies) > self.straggler_factor * med]


def shrink_mesh(mesh_shape, axes, failed_fraction_of_data: int = 1):
    """New (shape, axes) after dropping `failed_fraction_of_data` slices of
    the data axis.  Keeps the model axis intact (TP/EP groups must stay
    whole — a failed host kills its whole model-parallel replica)."""
    shape = list(mesh_shape)
    data_idx = axes.index("data")
    new_data = shape[data_idx] - failed_fraction_of_data
    if new_data < 1:
        raise RuntimeError("cannot shrink below one data replica")
    shape[data_idx] = new_data
    return tuple(shape), tuple(axes)


def reassign_shards(n_shards: int, bad: List[int]) -> Dict[int, List[int]]:
    """Round-robin reassignment of bad hosts' data shards to healthy hosts.
    Returns {healthy_host: [shard_ids it now also owns]}."""
    healthy = [h for h in range(n_shards) if h not in bad]
    if not healthy:
        raise RuntimeError("no healthy hosts")
    extra: Dict[int, List[int]] = {h: [] for h in healthy}
    for i, b in enumerate(sorted(bad)):
        extra[healthy[i % len(healthy)]].append(b)
    return extra


class ElasticTrainer:
    """Glue object used by launch/train.py: owns the monitor, decides when
    to re-mesh, and exposes the shard map for the data pipeline."""

    def __init__(self, n_data_shards: int, timeout: float = 60.0,
                 now=time.monotonic):
        self.monitor = HealthMonitor(list(range(n_data_shards)),
                                     timeout=timeout, now=now)
        self.n_data_shards = n_data_shards
        self.generation = 0

    def step_report(self, host: int, latency: float):
        self.monitor.beat(host, latency)

    def plan_step(self):
        """Returns (needs_remesh, shard_assignment)."""
        failed = self.monitor.failed_hosts()
        if failed:
            self.generation += 1
            self.n_data_shards -= len(failed)
            for h in failed:
                del self.monitor.hosts[h]
            return True, None
        stragglers = self.monitor.stragglers()
        if stragglers:
            return False, reassign_shards(self.n_data_shards, stragglers)
        return False, None
