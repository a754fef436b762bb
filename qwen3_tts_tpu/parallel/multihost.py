"""Multi-host serving topology (DCN tier).

The reference is single-host by construction ("dual_npu" = two NPUs on
one board; SURVEY §2 distributed-comm row). This build's cross-host
story, per the survey's design stance: tensor parallelism NEVER crosses a
host (tp collectives must ride the links between a host's local cards), data
parallelism MAY span hosts (per-step dp communication is nil in serving —
slots are independent — so DCN only carries admission/harvest traffic).

This module is the thin, testable layer that encodes that placement rule:

- ``init_distributed()``: ``jax.distributed.initialize`` from env/args
  (no-op for a single process, so single-host deployments never pay it).
- ``make_serving_mesh(tp)``: a global dp x tp Mesh where each tp group is
  guaranteed to live inside one process/host, and dp enumerates
  host-major so batcher slot blocks map to hosts contiguously
  (serve/batching allocates paged sub-pools per dp group — with this
  ordering a group's pages live on one host's chips).

A full multi-host daemon additionally needs request routing (each host
fronts its own slots); that composes from the existing daemon + this
mesh and is deliberately not a new subsystem — per-request state never
crosses hosts.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh

from qwen3_tts_tpu.parallel.mesh import DP, TP


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed from args or QWEN3_TTS_* env vars.

    Returns True if distributed mode was initialized, False for the
    single-process case (the common path; nothing is touched then).
    Env surface (mirrors the reference's env-first config layering,
    launch_qwen3_tts.sh:22-52): QWEN3_TTS_COORDINATOR ("host:port"),
    QWEN3_TTS_NUM_PROCESSES, QWEN3_TTS_PROCESS_ID.
    """
    coordinator = coordinator or os.environ.get("QWEN3_TTS_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("QWEN3_TTS_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("QWEN3_TTS_PROCESS_ID", "0"))
    if num_processes <= 1:
        return False
    if not coordinator:
        # an unambiguous misconfiguration: silently returning False here
        # would start this host as an independent single-process daemon
        # while the other processes block in initialize() waiting for it
        # (review finding) — fail loudly instead
        raise ValueError(
            f"QWEN3_TTS_NUM_PROCESSES={num_processes} but no coordinator "
            "address: set QWEN3_TTS_COORDINATOR=host:port (or pass "
            "coordinator=)")
    # Generous timeouts by default: first-run XLA compiles on a cold
    # machine take minutes and are NOT synchronized across processes, so
    # the default 300 s init/shutdown barriers are routinely blown by
    # compile skew (round-3 flake: one worker finished while the other
    # was still compiling, shutdown barrier saw 1/2 tasks). Env-tunable
    # like the rest of the QWEN3_TTS_* surface.
    init_timeout = int(os.environ.get("QWEN3_TTS_DIST_INIT_TIMEOUT", "900"))
    shutdown_timeout = int(
        os.environ.get("QWEN3_TTS_DIST_SHUTDOWN_TIMEOUT", "900"))
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               initialization_timeout=init_timeout,
                               shutdown_timeout_seconds=shutdown_timeout)
    return True


def barrier(name: str, timeout_s: float = 900.0) -> None:
    """Block until every process reaches this barrier (coordination
    service, gRPC — NOT a device collective).

    Use this to fence phases whose duration varies wildly per process
    (cold XLA compiles run minutes and are unsynchronized): a device
    collective (``multihost_utils.sync_global_devices``) would itself
    sit in a gloo/NCCL collective whose transport timeout the skew can
    blow, while the coordination-service barrier waits the full
    ``timeout_s`` regardless of transport. No-op single-process."""
    from jax._src import distributed as _dist

    client = _dist.global_state.client
    if client is None:  # single-process: nothing to synchronize
        return
    client.wait_at_barrier(name, timeout_in_ms=int(timeout_s * 1000))


def shutdown_distributed() -> None:
    """Explicitly tear down jax.distributed (idempotent, single-process
    safe). Call after a final ``barrier()`` so no process exits while a
    peer still needs the coordination service."""
    from jax._src import distributed as _dist

    if _dist.global_state.client is None:
        return
    jax.distributed.shutdown()


def make_serving_mesh(tp: int,
                      devices: Optional[Sequence[jax.Device]] = None,
                      dp: Optional[int] = None) -> Mesh:
    """Build a dp x tp Mesh whose tp groups never cross a host.

    Devices are grouped by ``device.process_index`` and laid out
    host-major: with H hosts of D local devices each, the mesh is
    ``(H * D // tp, tp)`` and rows [h*D//tp, (h+1)*D//tp) belong to host
    h — tp collectives ride intra-host links, the dp axis is the only one that can
    touch DCN. ``dp`` (optional) caps the dp extent (uses the first
    dp*tp devices in host-major order).
    """
    devs = list(devices) if devices is not None else list(jax.devices())
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    by_proc = {}
    for d in devs:
        by_proc.setdefault(d.process_index, []).append(d)
    ordered = []
    for proc in sorted(by_proc):
        local = by_proc[proc]
        if len(local) % tp:
            raise ValueError(
                f"host/process {proc} has {len(local)} devices, not "
                f"divisible by tp={tp} — tp groups must not cross hosts")
        ordered.extend(local)
    total_dp = len(ordered) // tp
    if dp is not None:
        if dp > total_dp:
            raise ValueError(f"dp={dp} needs {dp * tp} devices, "
                             f"have {len(ordered)}")
        total_dp = dp
    chosen = ordered[: total_dp * tp]
    # every participating process must keep at least one device in the
    # mesh: in multi-controller JAX a process with zero addressable
    # devices errors (or hangs the others' collectives) the first time it
    # runs a computation over this mesh (review finding)
    stranded = sorted(set(by_proc) - {d.process_index for d in chosen})
    if stranded:
        raise ValueError(
            f"dp={total_dp} x tp={tp} uses only the first "
            f"{total_dp * tp} devices and leaves process(es) {stranded} "
            "with no mesh devices — lower tp/dp or pass an explicit "
            "device subset that keeps every process represented")
    grid = np.asarray(chosen, dtype=object)
    grid = grid.reshape(total_dp, tp)
    return Mesh(grid, (DP, TP))


def host_slot_range(mesh: Mesh, batch_size: int,
                    process_index: Optional[int] = None):
    """The contiguous [lo, hi) slot range owned by ``process_index``'s dp
    rows under the batch-over-dp sharding (slots shard over dp in
    contiguous blocks; parallel/mesh.gen_state_spec). This is what a
    multi-host daemon uses to route requests to the host that holds the
    slot's KV (and, paged, its page sub-pool)."""
    if process_index is None:
        process_index = jax.process_index()
    dp_size = mesh.shape[DP]
    if batch_size % dp_size:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"dp {dp_size}")
    slots_per_dp = batch_size // dp_size
    rows = [i for i in range(dp_size)
            if mesh.devices[i, 0].process_index == process_index]
    if not rows:
        return (0, 0)
    lo, hi = min(rows), max(rows) + 1
    if rows != list(range(lo, hi)):  # host-major ordering guarantees this
        raise AssertionError("dp rows of one host are not contiguous")
    return (lo * slots_per_dp, hi * slots_per_dp)
