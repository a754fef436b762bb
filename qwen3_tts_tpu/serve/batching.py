"""Continuous batching: multi-request talker decode in one batched program.

New capability relative to the reference (batch=1 everywhere, SURVEY §2
parallelism table); this is the daemon-serving tier. Design:

- one persistent batched ``GenState`` with B slots; the fused decode loop
  (engine/generate.py) advances ALL slots in lockstep, `decode_chunk`
  tokens per program invocation;
- between chunks the scheduler admits queued requests into free slots
  (batch-1 prefill, then a jitted slot-insert that splices the new KV /
  hidden / bookkeeping into the batched state) and harvests finished
  slots (EOS or per-slot token budget — the loop enforces per-slot
  bounds, so slots recycle indefinitely);
- finished requests run the chunked vocoder and resolve their futures.

On a dp x tp mesh the same state/batch is sharded with
parallel/mesh.gen_state_spec — the scheduler code is mesh-agnostic.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from qwen3_tts_tpu.config import SAMPLES_PER_TOKEN, TTSConfig
from qwen3_tts_tpu.engine import generate as gen
from qwen3_tts_tpu.models import talker as tk
from qwen3_tts_tpu.models import transformer as tfm
from qwen3_tts_tpu.models import vocoder as voc
from qwen3_tts_tpu.models import vocoder_stream as vstream
from qwen3_tts_tpu.ops import sampling as smp


class OverloadedError(RuntimeError):
    """submit() rejected a request because the waiting pool is at
    ``max_queue``. Raised synchronously (never parked on a Future) so
    callers can shed load immediately — the daemon maps it to a
    structured "overloaded" error and the HTTP gateway to 503 +
    Retry-After, the standard serving backpressure contract. Without a
    bound, a traffic spike would grow the queue (and every request's
    latency) without limit — the failure the reference never faces at
    batch=1 but a serving tier must."""


class _Request:
    def __init__(self, text_ids, n_text, seed, max_tokens=None,
                 on_chunk=None, ref_codes=None, n_target=None,
                 priority=0, order=0):
        self.text_ids = text_ids
        # n_text arrives as a host int at submit(); keep BOTH forms —
        # the device scalar feeds the prefill programs, the host int
        # feeds the admission pos-mirror update (int() on the device
        # scalar would be a blocking d2h round trip per admission on the
        # scheduler thread, exactly what the mirror design eliminates)
        self.n_text = np.int32(n_text)
        self.n_text_host = int(n_text)
        self.seed = seed
        self.max_tokens = max_tokens
        # voice cloning: pre-encoded reference codec frames (R, 16) and
        # the TARGET text's token count (EOS pacing covers the target
        # only; text_ids hold ref_text ++ target_text — the engine
        # prompt_dir contract, engine/engine._prefill_cloned)
        self.ref_codes = ref_codes
        self.n_target = n_target
        # admission order among waiting requests: highest priority first,
        # FIFO (submit order) within a priority level
        self.priority = priority
        self.order = order
        # set at admission: (padded ref bucket, n_ref kept) — computed
        # once per request (a backlogged paged request retries admission
        # every step; re-bucketing would also re-print the truncation
        # warning each time), and the kept count feeds the host pos
        # mirror (prefix_len includes the ref rows)
        self.cloned_prep = None
        # set by the submitter (e.g. a daemon timeout / dead connection)
        # to withdraw the request: _admit skips it while queued, and an
        # ADMITTED slot is freed at the next chunk boundary (its future
        # fails with "request cancelled") instead of decoding the rest of
        # the utterance for nobody
        self.cancelled = False
        # streaming: called with each new int16 audio segment as soon
        # as its tokens are final (conv-exact windows, paced emissions).
        # Runs on the SCHEDULER thread — it must not block (queue the
        # segment and return; serve/daemon._handle_batched does this)
        self.on_chunk = on_chunk
        self.rendered = 0              # code frames fed to the stream
        self.audio_parts: List[np.ndarray] = []
        self.stream_error: Optional[BaseException] = None
        # incremental vocoder stream (models/vocoder_stream.py): device
        # state pytree, created at the first emission, advanced per
        # chunk; stream_kept counts samples emitted so far (the stream
        # runs output_crop samples behind rendered*1920 by design)
        self.voc_stream = None
        self.stream_kept = 0
        self.future: Future = Future()
        # latency instrumentation (tools/dev/bench_serving.py): queue wait
        # = t_admit - t_submit; admission -> first token = t_first -
        # t_admit (observed at chunk granularity); admission -> audio =
        # t_done - t_admit
        self.t_submit = time.perf_counter()
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None


def _empty_state(cfg: TTSConfig, batch: int, dtype,
                 paged_kv: "tfm.PagedKV" = None) -> gen.GenState:
    geo = tfm.geometry_of(cfg.talker)
    W = cfg.sampling.repetition_window
    kv = paged_kv if paged_kv is not None else tfm.init_kv_cache(
        geo, batch, cfg.talker.max_seq_len, dtype=dtype)
    return gen.GenState(
        kv=kv,
        pos=jnp.zeros((batch,), jnp.int32),
        hidden=jnp.zeros((batch, cfg.talker.hidden_size), dtype),
        ring=jnp.full((batch, W), -1, jnp.int32),
        n_codes=jnp.zeros((batch,), jnp.int32),
        done=jnp.ones((batch,), jnp.bool_),   # all slots free
        codes=jnp.zeros((batch, cfg.max_tokens, 16), jnp.int32),
        n_text=jnp.zeros((batch,), jnp.int32),
        step=jnp.int32(0),
        key=gen.batch_keys(smp.host_prng_key(0), batch),
        budget=jnp.full((batch,), cfg.max_tokens, jnp.int32),
    )


def _insert_slot(state: gen.GenState, slot: jax.Array,
                 sub: gen.GenState) -> gen.GenState:
    """Splice a batch-1 post-prefill state into ``slot`` of the batch.

    The spliced request's PER-ELEMENT PRNG key comes along, so the seed
    passed to submit() fully determines the request's samples — identical
    to a solo batch-1 run with the same key (round-1 advisor finding)."""
    return gen.GenState(
        kv=state.kv.at[:, :, slot].set(sub.kv[:, :, 0]),
        pos=state.pos.at[slot].set(sub.pos[0]),
        hidden=state.hidden.at[slot].set(sub.hidden[0]),
        ring=state.ring.at[slot].set(sub.ring[0]),
        n_codes=state.n_codes.at[slot].set(0),
        done=state.done.at[slot].set(False),
        codes=state.codes.at[slot].set(0),
        n_text=state.n_text.at[slot].set(sub.n_text[0]),
        step=state.step,
        key=state.key.at[slot].set(sub.key[0]),
        budget=state.budget.at[slot].set(sub.budget[0]),
    )


def _insert_slot_paged(state: gen.GenState, slot: jax.Array,
                       sub: gen.GenState, table_row: jax.Array,
                       capacity: jax.Array, *, n_rows: int) -> gen.GenState:
    """Paged variant of _insert_slot: install the slot's page-table row and
    capacity, then splice the first ``n_rows`` dense prefill rows into its
    pages."""
    paged = state.kv._replace(
        table=state.kv.table.at[slot].set(table_row),
        capacity=state.kv.capacity.at[slot].set(capacity))
    paged = tfm.paged_scatter_rows(paged, slot, sub.kv[:, :, 0, :n_rows])
    return gen.GenState(
        kv=paged,
        pos=state.pos.at[slot].set(sub.pos[0]),
        hidden=state.hidden.at[slot].set(sub.hidden[0]),
        ring=state.ring.at[slot].set(sub.ring[0]),
        n_codes=state.n_codes.at[slot].set(0),
        done=state.done.at[slot].set(False),
        codes=state.codes.at[slot].set(0),
        n_text=state.n_text.at[slot].set(sub.n_text[0]),
        step=state.step,
        key=state.key.at[slot].set(sub.key[0]),
        budget=state.budget.at[slot].set(sub.budget[0]),
    )


class ContinuousBatcher:
    """Fixed-slot continuous batching scheduler over the fused decode loop.

    ``paged=True`` switches the talker KV to the block-paged pool
    (models/transformer.PagedKV + paged_decode_attention): slots own
    ``page_size``-row pages of a shared pool via per-slot page tables; the
    scheduler grows a slot's table between decode chunks and recycles
    pages at harvest. Generation length then decouples from a dense
    ``max_seq_len`` allocation — a single request can run to
    ``cfg.max_tokens`` even past the dense cap, and pool memory tracks
    actual usage instead of batch x worst-case (SURVEY §7 hard part 4).

    Paged composes with ``mesh``: pages shard over dp as per-group
    sub-pools (allocation never crosses a group, so the shard_map'd paged
    attention stays collective-free), kv heads over tp
    (parallel/mesh.paged_kv_spec)."""

    def __init__(self, cfg: TTSConfig, params: Dict, batch_size: int = 4,
                 decode_chunk: int = 16, dtype=jnp.bfloat16, mesh=None,
                 quantize_talker: bool = False,
                 quantize_cp: bool = True,
                 paged: bool = False, page_size: int = 64,
                 pool_pages: Optional[int] = None,
                 max_pages_per_slot: Optional[int] = None,
                 pipeline_depth: int = 1,
                 prefix_cache: int = 8,
                 max_queue: Optional[int] = None):
        """``mesh``: optional jax.sharding.Mesh (dp x tp). When given, the
        parameters are tensor-sharded and the batched decode state is
        batch-sharded over dp / kv-head-sharded over tp
        (parallel/mesh.py). The scheduler logic itself is mesh-agnostic.

        ``quantize_talker``: weight-only int8 for the TALKER only
        (batching amortizes the weight bytes int8 saves); an
        experimentation knob, off by default. Single-device only: its
        fused qkv/gateup int8 layout has no mesh specs.

        ``quantize_cp`` (default on): int8 code predictor — half the
        bytes of the CP layer stack its 14 sequential steps re-read per
        token, on one device or a mesh (QTensor sharding specs in
        parallel/mesh.adapt_spec_to_params).

        ``pipeline_depth``: 1 (default) harvests each decode chunk before
        dispatching the next — the device idles for one d2h round trip
        per chunk while the host reads the post-run status. 2 dispatches
        chunk k+1 BEFORE harvesting chunk k (speculative chunk
        pipelining), hiding that round trip behind device compute —
        higher steady-state throughput, at the cost of results and
        streaming emissions surfacing one chunk later (device programs
        execute in dispatch order, so a chunk's vocoder windows queue
        behind the next speculative chunk), finished slots burning one
        frozen (no-op) chunk before recycling, and one extra GenState
        pinned in HBM (the un-harvested chunk's output — the full KV
        pool plus codes buffers; no buffer donation).

        ``prefix_cache``: admission prefix LRU capacity in entries (0
        disables). Repeat admissions with the same text (and, for voice
        cloning, the same reference codes — i.e. the same prompt_dir)
        skip the prefill dispatch entirely; seed and budget attach at
        assembly so different seeds share one entry. Each entry pins a
        batch-1 KV at the prefill window (dense tier: max_seq_len rows;
        paged tier: the page-aligned prefix window).

        ``max_queue``: backpressure bound on the waiting pool (queued +
        priority pool + paged backlog; None = unbounded). At the bound,
        submit() raises OverloadedError instead of growing every
        request's queue wait — callers shed load (HTTP: 503)."""
        if pipeline_depth not in (1, 2):
            raise ValueError(f"pipeline_depth must be 1 or 2, "
                             f"got {pipeline_depth}")
        self.pipeline_depth = pipeline_depth
        self.cfg = cfg
        from qwen3_tts_tpu.ops import quant as quant_ops
        if (quant_ops.is_quantized(params.get("talker", {}))
                and not (quantize_talker and mesh is None)):
            # pre-quantized engine-mode artifact (convert_weights.py
            # --quantize int8): the batched tier wants a dense talker at
            # the tier's dtype — batching amortizes the weight bytes int8
            # saves, and the fused layout has no mesh sharding specs.
            # This policy lives
            # HERE (not in daemon.main) so every batcher caller gets it.
            import functools
            print("ContinuousBatcher: pre-quantized talker -> dense "
                  f"{jnp.dtype(dtype).name} for the batched tier "
                  "(prefer a --quantize int8-cp artifact for serving)",
                  file=sys.stderr, flush=True)
            params = {**params,
                      "talker": jax.jit(functools.partial(
                          quant_ops.dequantize_talker, dtype=dtype))(
                              params["talker"])}
        if quantize_talker and mesh is None:
            if "qkv_proj" not in params["talker"]["layers"]:
                params = {**params,
                          "talker": quant_ops.quantize_talker(
                              params["talker"])}
            elif "layers_list" not in params["talker"]:
                # already-quantized weights (a --quantize int8 artifact
                # handed in with quantize_talker=True): npz loading
                # strips the per-layer weight list the unrolled int8
                # decode path keys off — rebuild it, or talker.decode
                # silently falls back to the stacked scan (an HBM copy
                # of every layer's weights per step) and the int8-vs-
                # bf16 serving A/B measures the wrong implementation
                params = {**params,
                          "talker": jax.jit(quant_ops.attach_layer_list)(
                              params["talker"])}
        if quantize_cp:
            # quantize at every batch size: an earlier batch<=8 guard
            # here silently served a FLOAT CP at larger batches while the
            # docstring promised int8 (review finding).
            from qwen3_tts_tpu.ops.quant import QTensor
            if not isinstance(params["code_predictor"]["lm_heads"],
                              QTensor):
                params = {**params,
                          "code_predictor":
                              quant_ops.quantize_code_predictor(
                                  params["code_predictor"])}
        self.mesh = mesh
        if mesh is not None:
            from qwen3_tts_tpu.parallel import mesh as pmesh
            core = {k: params[k] for k in ("talker", "code_predictor")
                    if k in params}
            params = {**params, **pmesh.shard_params(mesh, core)}
            self._state_shardings = jax.tree.map(
                lambda sp: jax.sharding.NamedSharding(mesh, sp),
                pmesh.gen_state_spec(cfg, paged=paged),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        else:
            self._state_shardings = None
        # multi-process (DCN) lockstep mode: when the mesh spans >1
        # process, every process runs this scheduler with IDENTICAL
        # submissions in identical order (the lockstep frontend's
        # contract — tests/dcn_serve_worker.py), so all dispatch the same
        # global program sequence. Per chunk the only cross-process
        # traffic is the tiny replicated status gather (_fetch_status) —
        # the executable form of "DCN carries only admission/harvest"
        # (docs/ARCHITECTURE.md). Each process vocodes and resolves ONLY
        # its host_slot_range slice; peer-owned slots resolve to the
        # (None, None) remote marker.
        self._multiproc = (
            mesh is not None
            and len({d.process_index for d in mesh.devices.flat}) > 1)
        self._host_slots = (0, batch_size)
        if self._multiproc:
            from qwen3_tts_tpu.parallel import multihost as mh
            self._host_slots = mh.host_slot_range(mesh, batch_size)
            rep = jax.sharding.NamedSharding(mesh,
                                             jax.sharding.PartitionSpec())
            self._gather_status_fn = jax.jit(
                lambda d, n, p: (d, n, p), out_shardings=(rep, rep, rep))
        self.params = params
        self.batch_size = batch_size
        self.decode_chunk = decode_chunk
        self.dtype = dtype

        self.paged = paged
        paged_kv = None
        if paged:
            geo = tfm.geometry_of(cfg.talker)
            self.page_size = page_size
            # default pool: enough pages for every slot to reach
            # max_tokens + a max-size prefix — same worst-case ceiling as
            # dense, but shareable: one long request can use pages idle
            # slots don't
            from qwen3_tts_tpu.models.talker import PREFIX_EXTRA
            worst = cfg.max_tokens + 256 + PREFIX_EXTRA + page_size
            per_slot = -(-worst // page_size)
            self.max_pages_per_slot = max_pages_per_slot or per_slot
            # On a mesh, pages shard over dp (parallel/mesh.paged_kv_spec):
            # the pool splits into one contiguous sub-pool per dp group and
            # a slot only ever holds pages from ITS group's range, so the
            # shard_map'd paged attention (tfm._paged_write_attend_local)
            # stays local to the shard. Page g*pages_per_group of each
            # group is reserved: zeroed table entries localize to it.
            # Single chip is the 1-group special case (reserved page 0).
            self._n_groups = mesh.shape["dp"] if mesh is not None else 1
            if batch_size % self._n_groups:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by dp "
                    f"{self._n_groups}")
            slots_per_group = batch_size // self._n_groups
            per_group = slots_per_group * per_slot + 1
            if pool_pages:
                per_group = -(-pool_pages // self._n_groups)
            self._pages_per_group = per_group
            self.pool_pages = per_group * self._n_groups
            paged_kv = tfm.init_paged_kv(
                geo, batch_size, self.pool_pages, page_size,
                self.max_pages_per_slot, dtype=dtype)
            self._free_by_group: List[List[int]] = [
                list(range(g * per_group + 1, (g + 1) * per_group))
                for g in range(self._n_groups)]
            self._slot_pages: List[List[int]] = [[] for _ in
                                                 range(batch_size)]

            def _grow_many_fn(state, slots, idxs, pages, valid):
                # ONE jitted table/capacity update for a whole round of
                # page grows (one dispatch per page grow multiplied the
                # per-dispatch cost).
                # Padding entries duplicate a real entry (idempotent
                # scatter-set) with valid=0 so capacity is unchanged;
                # duplicate slots in `slots` accumulate correctly in the
                # scatter-add.
                kv = state.kv._replace(
                    table=state.kv.table.at[slots, idxs].set(pages),
                    capacity=state.kv.capacity.at[slots].add(
                        page_size * valid))
                return state._replace(kv=kv)

            def _release_fn(state, slot):
                # zero the slot's table row BEFORE its pages recycle:
                # frozen (done) slots keep rewriting K/V at their last
                # position every chunk, and through a stale table that
                # write would corrupt pages reallocated to other slots.
                # Zeroed entries land in reserved page 0 (never read:
                # logical reads are masked by pos within capacity).
                kv = state.kv._replace(
                    table=state.kv.table.at[slot].set(0),
                    capacity=state.kv.capacity.at[slot].set(0))
                return state._replace(kv=kv)

            self._grow_many = jax.jit(_grow_many_fn)
            self._release = jax.jit(_release_fn)

        self._state = _empty_state(cfg, batch_size, dtype, paged_kv)
        if self._state_shardings is not None:
            self._state = jax.device_put(self._state, self._state_shardings)
        self._slot_req: List[Optional[_Request]] = [None] * batch_size
        # (done, pos) host mirrors stashed by the harvest's combined
        # post-run fetch: step() consumes them instead of re-fetching the
        # same values, removing one blocking d2h round trip per decode
        # chunk. None = must fetch.
        self._status_mirror: Optional[tuple] = None
        # pipeline_depth=2: the run output dispatched last step, harvested
        # one step late (after the next chunk is already in flight)
        self._pending = None
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # priority pool: the scheduler drains the intake queue here and
        # picks (highest priority, then FIFO). Scheduler-thread-only.
        self._waiting: List[_Request] = []
        self.max_queue = max_queue
        self._order = 0              # submit sequence (under _submit_lock)
        self._stop = threading.Event()
        self._draining = False
        self._closed = False
        self._submit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

        def _prefix_fn(pcfg):
            # the deterministic half of admission: dual-stream prefix +
            # talker prefill -> (hidden, kv, plen). No seed or budget
            # enters, so the result is cacheable across requests with the
            # same text (the batched analog of the engine's prefix LRU /
            # the reference's talker KV persistence,
            # llamacpp_talker_server.py:208-246)
            def fn(tp, ids, n_text):
                prefix, plen = tk.build_prefix(tp, ids, n_text)
                hidden, kv = gen.prefill_state(
                    tp, prefix[None].astype(tp["codec_embedding"].dtype),
                    plen[None], pcfg)
                return hidden, kv, plen[None]
            return jax.jit(fn)

        def _prefix_cloned_fn(pcfg):
            # voice-cloning admission: cloned dual-stream prefix (ref
            # frames as continuation rows) — the same contract as
            # engine._mk_state_cloned. n_target (EOS pacing) joins at
            # assembly, not here, so one cached prefill serves any
            # n_target with the same text+ref
            def fn(tp, cp_embs, ids, n_text, ref_codes, n_ref):
                prefix, plen = tk.build_prefix_cloned(
                    tp, cp_embs, ids, n_text, ref_codes, n_ref)
                hidden, kv = gen.prefill_state(
                    tp, prefix[None].astype(tp["codec_embedding"].dtype),
                    plen[None], pcfg)
                return hidden, kv, plen[None]
            return jax.jit(fn)

        def _assemble_insert_fn(state, slot, hidden, kv, plen, n_pace,
                                key, budget):
            # per-request tail (seed/budget + zeroed carries) FUSED into
            # the slot splice: a cache hit admits in ONE program
            # invocation (each invocation pays a dispatch); a miss pays
            # prefix + this = two, the same count as the unsplit round-3
            # prefill+insert pair
            sub = gen.assemble_state(hidden, kv, plen, n_pace[None], key,
                                     cfg, budget=budget)
            return _insert_slot(state, slot, sub)

        def _assemble_insert_paged_fn(state, slot, hidden, kv, plen,
                                      n_pace, key, budget, table_row,
                                      capacity, *, n_rows):
            sub = gen.assemble_state(hidden, kv, plen, n_pace[None], key,
                                     cfg, budget=budget)
            return _insert_slot_paged(state, slot, sub, table_row,
                                      capacity, n_rows=n_rows)

        self._prefix_one = _prefix_fn(cfg)
        self._prefix_cloned_one = _prefix_cloned_fn(cfg)
        self._make_prefix_plain = _prefix_fn
        self._make_prefix_cloned = _prefix_cloned_fn
        self._insert_assembled = jax.jit(_assemble_insert_fn)
        self._insert_assembled_paged = jax.jit(
            _assemble_insert_paged_fn, static_argnames=("n_rows",))
        # paged prefix programs keyed by (page-aligned window, cloned?)
        self._prefill_cache: Dict[tuple, object] = {}
        # admission prefix LRU (VERDICT r3 Weak #5): (hidden, kv, plen)
        # device tuples keyed by the full numerical identity of the
        # prefix — text ids bytes, n_text, bucketed ref bytes, n_ref,
        # prefill window. A serving workload with few voices / repeated
        # prompt_dirs skips the whole prefill dispatch on repeats (seed
        # and budget join at assembly, so different seeds share entries).
        # Entries hold a batch-1 KV at the prefill window: dense tier =
        # max_seq_len rows, paged tier = the page-aligned prefix window
        # (much smaller). jax arrays are immutable; the fused
        # assemble+insert programs copy into the batch state, so sharing
        # one entry across concurrent admissions is safe.
        self.prefix_cache_size = prefix_cache
        self._prefix_lru: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        self._backlog: List[_Request] = []
        # stop(): force abandoned mid-decode slots to done so a restarted
        # batcher sees them as free (admission fully overwrites slot state)
        self._mark_done = jax.jit(
            lambda s, m: s._replace(done=jnp.logical_or(s.done, m)))

        def _run_fn(tp, cpp, s):
            if self._state_shardings is not None:
                s = jax.lax.with_sharding_constraint(s, self._state_shardings)
            # the dense mesh path is pure GSPMD; only the paged path needs
            # the mesh object (shard_map inside the paged attention)
            return gen.run_steps(tp, cpp, s, cfg, jnp.int32(decode_chunk),
                                 mesh=mesh if paged else None)

        self._run = jax.jit(_run_fn)
        # int16 on device: halves every audio d2h —
        # the serving tier fetches per-emission windows, so it benefits
        # even more than the CLI path (review finding); voc.to_int16
        # passes int16 through, so daemon consumers are unchanged
        self._voc = jax.jit(
            lambda vp, codes: voc.to_int16_device(
                voc.decode(vp, codes, cfg.vocoder)))

        def _voc_slot_fn(vp, codes_row, W):
            # one slot's codes (T, 16), padded/sliced to a static W-token
            # window (vocoder.pad_codes — shared with the engine's
            # _voc_pad), decoded on device: dispatched on the DEVICE
            # value so the vocoder starts before any codes fetch completes
            return voc.to_int16_device(
                voc.decode(vp, voc.pad_codes(codes_row, W)[None],
                           cfg.vocoder))

        self._voc_slot = jax.jit(_voc_slot_fn, static_argnames=("W",))
        # incremental streaming vocoder step programs: the shared
        # fixed-size stepper (models/vocoder_stream.StreamStepper — also
        # the engine streaming path's programs since r5, so both tiers
        # compile the identical step HLO once per geometry)
        self._stepper = vstream.StreamStepper(cfg.vocoder)

    # fixed streaming-step chunk sizes: arbitrary emission extents are
    # decomposed greedily into these, so the whole serving lifetime uses
    # at most len(sizes) x 2 compiled programs per geometry
    STREAM_STEP_SIZES = vstream.StreamStepper.SIZES

    def _stream_step_fn(self, c: int, primed: bool):
        """Jitted incremental vocoder step (shared StreamStepper): slice
        ``c`` code frames from a slot's codes row at a runtime ``start``,
        advance the stream state, return int16 samples. The row is
        zero-extended before the slice so a flush step may read past the
        utterance end (zero-code lookahead — the synthesize_exact
        contract)."""
        return self._stepper.step_fn(c, primed)

    # -- public API ---------------------------------------------------------

    def submit(self, text_ids: np.ndarray, n_text: int,
               seed: int = 0, max_tokens: Optional[int] = None,
               on_chunk=None, ref_codes=None,
               n_target: Optional[int] = None,
               priority: int = 0) -> Future:
        """Queue a request; the Future resolves to
        (codes np[T,16], audio int16 np — converted on device; pass it
        straight to wav writers/``voc.to_int16``). ``max_tokens``: per-request
        cap — the slot stops (and frees) at that many tokens.

        ``on_chunk``: streaming — called FROM THE SCHEDULER THREAD (it
        must queue and return, never block) with each new int16 audio
        segment once its tokens are final, paced at >= 48 new tokens per
        emission (final segment always flushes). Segments come from the
        incremental vocoder stream (models/vocoder_stream.py) — O(new
        tokens) per emission even for long paged requests — and their
        concatenation equals the non-streaming result within the stream's
        contract (int16 +-1 LSB on < 0.01% of samples). Batched streaming
        is a capability the reference does not have at all (its streaming
        is single-request, client-internal; tts_client.py:189-197).

        ``ref_codes`` + ``n_target``: voice cloning — ``text_ids`` must
        hold ref_text ++ target_text, ``ref_codes`` the (R, 16) reference
        codec frames (a prompt_dir's ref_codec_tokens.npy), ``n_target``
        the target text's token count (EOS pacing). The admission prefill
        builds the cloned dual-stream prefix (talker.build_prefix_cloned)
        exactly like the engine's prompt_dir path.

        ``priority``: admission order among WAITING requests — higher
        admits first, FIFO within a level (in-flight slots are never
        preempted; a paged pool-pressure backlog keeps head-of-line, see
        _next_request). Raises OverloadedError when ``max_queue`` is set
        and the waiting pool is full."""
        if (ref_codes is None) != (n_target is None):
            raise ValueError("ref_codes and n_target go together")
        # the lock closes the submit-vs-stop race: either the request
        # lands in the queue BEFORE stop() drains it (and is failed
        # there), or it observes _closed and fails here — never a
        # forever-pending Future on a dead scheduler
        with self._submit_lock:
            if self.max_queue is not None:
                # len(_waiting)/_backlog are scheduler-thread-owned: this
                # read is approximate by one round, which is fine for a
                # load-shedding bound
                depth = (self._queue.qsize() + len(self._waiting)
                         + len(self._backlog))
                if depth >= self.max_queue:
                    raise OverloadedError(
                        f"server overloaded: {depth} requests waiting "
                        f"(max_queue={self.max_queue}); retry later")
            self._order += 1
            req = _Request(np.asarray(text_ids, np.int32), n_text,
                           seed, max_tokens, on_chunk,
                           ref_codes=(None if ref_codes is None
                                      else np.asarray(ref_codes, np.int32)),
                           n_target=n_target,
                           priority=int(priority), order=self._order)
            req.future.request = req  # expose timing (bench/metrics)
            if self._closed:
                req.future.set_exception(RuntimeError("batcher stopped"))
                return req.future
            self._queue.put(req)
        return req.future

    def occupancy(self) -> dict:
        """Scheduler occupancy snapshot for the daemon's stats endpoint
        (approximate: read without pausing the scheduler thread)."""
        active = sum(1 for r in self._slot_req if r is not None)
        snap = {
            "batch_size": self.batch_size,
            "active_slots": active,
            "queued": (self._queue.qsize() + len(self._waiting)
                       + len(self._backlog)),
            "paged": self.paged,
            "prefix_cache": {"entries": len(self._prefix_lru),
                             "capacity": self.prefix_cache_size,
                             "hits": self.prefix_hits,
                             "misses": self.prefix_misses},
        }
        if self.paged:
            snap["free_pages"] = len(self._free_pages)
        return snap

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            if self._closed:
                raise RuntimeError(
                    "batcher scheduler thread from a previous stop() is "
                    "still alive; cannot restart")
            # already running (e.g. started manually before being handed
            # to the daemon): a second concurrent scheduler over the same
            # device state would corrupt it — idempotent no-op instead
            return
        self._closed = False
        # re-arm the stop flag: a clean stop() clears it, but the
        # 3-consecutive-failure halt leaves it SET — without this a
        # recovery start() would spawn a thread that exits immediately
        # while submits re-open and their Futures hang forever (review
        # finding)
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the scheduler. ``drain=True`` (default) stops admitting
        new requests but lets in-flight slots finish decoding (bounded by
        ``timeout``); anything still unfinished after the scheduler halts
        — queued, backlogged, or mid-decode — fails with a RuntimeError
        instead of leaving its Future pending forever (a client blocked
        on a dead scheduler would otherwise hang to its own timeout).
        A cleanly-stopped batcher can ``start()`` again (abandoned
        mid-decode slots are marked done on device so admission can
        recycle them); a stop that could not join the scheduler thread
        is not restartable."""
        if drain and self._thread is not None and self._thread.is_alive():
            self._draining = True
            deadline = time.monotonic() + timeout
            while (any(r is not None for r in self._slot_req)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        self._stop.set()
        joined = True
        if self._thread is not None:
            self._thread.join(timeout=max(timeout, 10.0))
            joined = not self._thread.is_alive()
        with self._submit_lock:
            self._closed = True
            leftovers = []
            while True:
                try:
                    leftovers.append(self._queue.get_nowait())
                except queue.Empty:
                    break
        leftovers += self._waiting + self._backlog
        self._waiting = []
        self._backlog = []
        if not joined:
            # the scheduler thread is wedged inside a device call (e.g. a
            # minutes-long first compile): it still owns the slots and
            # device state, so touching them here would race it — fail
            # only the queued work and leave the stop signal set; the
            # thread exits at its next loop check. Not restartable.
            for r in leftovers:
                if not r.future.done():
                    r.future.set_exception(RuntimeError("batcher stopped"))
            return
        leftovers += [r for r in self._slot_req if r is not None]
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(RuntimeError("batcher stopped"))
        # the mark-done / release below change device state the stashed
        # (done, pos) mirrors no longer describe
        self._status_mirror = None
        self._pending = None
        abandoned = [s for s in range(self.batch_size)
                     if self._slot_req[s] is not None]
        if abandoned:
            # a non-drained stop leaves device done=False on these slots;
            # without this a restarted batcher would never see them as
            # free (and, with every slot abandoned, never call _run) —
            # mark them done so admission can recycle them
            mask = np.zeros((self.batch_size,), bool)
            mask[abandoned] = True
            try:
                self._state = self._mark_done(self._state,
                                              mask)
            except Exception as e:
                # a dead device must not abort stop() mid-cleanup:
                # host-side teardown below still has to run so a later
                # start() isn't wedged by half-reset flags (same policy
                # as _abort_inflight's guarded release)
                print(f"batcher stop: mark-done failed ({e}); device "
                      "state abandoned", file=sys.stderr)
        if self.paged:
            # abandoned in-flight slots must return their pages (their
            # zeroed table rows alias reserved page 0, which is never
            # read, so any residual frozen-slot writes are harmless)
            for slot in range(self.batch_size):
                if self._slot_req[slot] is not None and self._slot_pages[slot]:
                    try:
                        self._state = self._release(self._state,
                                                    np.int32(slot))
                    except Exception:
                        # release failed: the slot's table row may still
                        # point at these pages — recycling them would hand
                        # corrupted pages to a future request. Leak them
                        # (bounded; same policy as _abort_inflight).
                        self._slot_pages[slot] = []
                        continue
                    self._free_by_group[self._slot_group(slot)].extend(
                        self._slot_pages[slot])
                    self._slot_pages[slot] = []
        self._slot_req = [None] * self.batch_size
        self._draining = False
        self._stop.clear()
        self._thread = None
        # clean stop: back to the pre-start state — submits queue again
        # (served by a future start() or manual step() driving)
        with self._submit_lock:
            self._closed = False

    # -- scheduler ----------------------------------------------------------

    def _fetch_status(self, state) -> tuple:
        """(done, n_codes, pos) as caller-owned host arrays — ONE round
        trip. Multi-process: a replicated gather over the mesh (the only
        per-chunk cross-process collective in serving), read from the
        local replica; both schedulers then see identical mirrors and
        make identical (lockstep) decisions."""
        if self._multiproc:
            d, n, p = self._gather_status_fn(state.done, state.n_codes,
                                             state.pos)
            return tuple(np.asarray(x.addressable_data(0)).copy()
                         for x in (d, n, p))
        return tuple(np.asarray(a).copy() for a in jax.device_get(
            (state.done, state.n_codes, state.pos)))

    def _owns(self, slot: int) -> bool:
        """Does this process hold ``slot``'s KV shard (host_slot_range)?
        Single-process: always."""
        lo, hi = self._host_slots
        return lo <= int(slot) < hi

    def _codes_row(self, state, slot: int):
        """One slot's (T, 16) codes as a LOCAL device value the vocoder
        programs can consume. Single-process: the device slice (keeps the
        chained-dispatch path — no fetch). Multi-process: the slot's rows
        live on this host's dp shard (callers only pass owned slots);
        read the local shard and re-host."""
        if not self._multiproc:
            return state.codes[slot]
        for sh in state.codes.addressable_shards:
            sl = sh.index[0]
            lo = sl.start or 0
            hi = (sl.stop if sl.stop is not None
                  else state.codes.shape[0])
            if lo <= slot < hi:
                return jnp.asarray(np.asarray(sh.data)[slot - lo])
        raise RuntimeError(f"slot {slot} has no local shard "
                           f"(host slots {self._host_slots})")

    def _cloned_inputs(self, req: "_Request", cap: int):
        """Bucket a cloning request's reference frames against a prefix
        budget of ``cap`` KV rows (dense: max_seq_len; paged: the slot's
        page capacity), leaving 8 rows of decode headroom — the same
        clamp as engine._prefill_cloned (tk.cloned_ref_limit is the one
        home for the formula). Returns (padded (b,16), n_ref)."""
        if req.cloned_prep is not None:
            return req.cloned_prep
        limit = tk.cloned_ref_limit(cap, int(req.text_ids.shape[0]))
        padded, n_ref = tk.bucket_ref_frames(limit, req.ref_codes)
        if n_ref < len(req.ref_codes):
            print(f"warning: reference audio truncated to {n_ref} frames "
                  f"(prefix budget {cap})", file=sys.stderr)
        req.cloned_prep = (padded, n_ref)
        return req.cloned_prep

    def _prefix_result(self, key: tuple, fn, *args) -> tuple:
        """Consult the admission prefix LRU; on miss run the prefix
        program ``fn(*args)`` and cache its (hidden, kv, plen). The key
        carries the prefix's full numerical identity (text ids bytes,
        n_text, prefill window[, bucketed ref bytes, n_ref]) — seed and
        budget are NOT part of the prefix, they join at assembly."""
        if self.prefix_cache_size > 0:
            hit = self._prefix_lru.get(key)
            if hit is not None:
                self._prefix_lru.move_to_end(key)
                self.prefix_hits += 1
                return hit
        out = fn(*args)
        self.prefix_misses += 1
        if self.prefix_cache_size > 0:
            self._prefix_lru[key] = out
            while len(self._prefix_lru) > self.prefix_cache_size:
                self._prefix_lru.popitem(last=False)
        return out

    def _req_budget(self, req: "_Request") -> int:
        mt = req.max_tokens
        return (min(int(mt), self.cfg.max_tokens) if mt is not None
                else self.cfg.max_tokens)

    def _free_slots(self, done: np.ndarray) -> List[int]:
        return [i for i in range(self.batch_size)
                if done[i] and self._slot_req[i] is None]

    def _slot_group(self, slot: int) -> int:
        """dp group owning ``slot`` (slots shard over dp in contiguous
        blocks, so group = slot // slots_per_group)."""
        return slot // (self.batch_size // self._n_groups)

    @property
    def _free_pages(self) -> List[int]:
        """All free page ids across groups (diagnostics/tests)."""
        return [p for g in self._free_by_group for p in g]

    def _next_request(self) -> Optional[_Request]:
        if self._draining:   # graceful stop: no new admissions
            return None
        # a paged pool-pressure backlog keeps absolute head-of-line
        # regardless of priority: it was already selected once, and
        # admitting around it while it waits for pages would starve it
        # exactly when the pool is tightest
        if self._backlog:
            return self._backlog.pop(0)
        while True:   # drain the intake into the priority pool
            try:
                self._waiting.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if not self._waiting:
            return None
        best = min(range(len(self._waiting)),
                   key=lambda i: (-self._waiting[i].priority,
                                  self._waiting[i].order))
        return self._waiting.pop(best)

    def _evict_cancelled(self, done: np.ndarray) -> frozenset:
        """Free admitted slots whose request was withdrawn (``cancelled``
        set by the submitter — daemon timeout, dead connection): fail the
        future, mark the slot done on device (ONE jitted update for the
        round, chained on the tail so the next chunk freezes it), recycle
        its pages, and flip the host mirror so this step's admission can
        reuse the slot immediately. Returns the evicted slot ids (the
        depth-2 harvest must exclude them: its fetched status predates
        the mark-done)."""
        victims = [s for s in range(self.batch_size)
                   if self._slot_req[s] is not None
                   and self._slot_req[s].cancelled and not done[s]]
        if not victims:
            return frozenset()
        mask = np.zeros((self.batch_size,), bool)
        mask[victims] = True
        self._state = self._mark_done(self._state, mask)
        for s in victims:
            r = self._slot_req[s]
            if not r.future.done():
                r.future.set_exception(RuntimeError("request cancelled"))
            self._slot_req[s] = None
            done[s] = True
            if self.paged and self._slot_pages[s]:
                # zero the table row before the pages recycle (same
                # ordering contract as the harvest release path)
                self._state = self._release(self._state, jnp.int32(s))
                self._free_by_group[self._slot_group(s)].extend(
                    self._slot_pages[s])
                self._slot_pages[s] = []
        return frozenset(victims)

    def _admit(self, done: np.ndarray, pos: np.ndarray) -> List[int]:
        """Admit queued requests into free slots; returns the admitted
        slot ids. Updates the caller's host-side ``done``/``pos`` mirrors
        in place (an admitted slot's done is False and its position is
        n_text + PREFIX_EXTRA — both host-computable), so the paged
        top-up never needs a post-admission device refresh round trip."""
        from qwen3_tts_tpu.models.talker import PREFIX_EXTRA

        admitted: List[int] = []
        exhausted = False
        for slot in self._free_slots(done):
            if exhausted:
                break
            while True:
                req = self._next_request()
                if req is None:
                    exhausted = True
                    break
                if req.cancelled:
                    if not req.future.done():
                        req.future.set_exception(
                            RuntimeError("request cancelled"))
                    continue
                # per-request isolation: a malformed request (oversized
                # prefix, prefill shape error, ...) fails ITS OWN future
                # and the slot moves on to the next request — it must
                # never crash the scheduler or wedge the backlog
                try:
                    if self.paged:
                        if not self._admit_paged(slot, req):
                            # transient pool pressure: retry later, and
                            # keep FIFO order (don't admit around it)
                            self._backlog.append(req)
                            exhausted = True
                            break
                    else:
                        S = self.cfg.talker.max_seq_len
                        p_pad = int(req.text_ids.shape[0]) + PREFIX_EXTRA
                        if req.ref_codes is not None:
                            # bucket FIRST: even a fully-truncated ref
                            # yields a >= 1-row pad bucket, so checking
                            # p_pad alone would admit a prefix one row
                            # past S and fail with an opaque XLA shape
                            # error instead of this ValueError
                            ref_pad, n_ref = self._cloned_inputs(req, S)
                            p_pad += int(ref_pad.shape[0])
                        if p_pad > S:
                            raise ValueError(
                                f"request prefix ({p_pad} rows incl. "
                                f"{PREFIX_EXTRA} special) exceeds the dense "
                                f"KV allocation (max_seq_len={S}); shorten "
                                f"the text or use the paged batcher")
                        ids_b = np.asarray(req.text_ids).tobytes()
                        if req.ref_codes is not None:
                            hidden, kv, plen = self._prefix_result(
                                (ids_b, req.n_text_host, S, True,
                                 np.asarray(ref_pad).tobytes(), int(n_ref)),
                                self._prefix_cloned_one,
                                self.params["talker"],
                                self.params["code_predictor"]["codec_embs"],
                                req.text_ids, req.n_text,
                                np.asarray(ref_pad), np.int32(n_ref))
                            n_pace = np.int32(req.n_target)
                        else:
                            hidden, kv, plen = self._prefix_result(
                                (ids_b, req.n_text_host, S, False),
                                self._prefix_one, self.params["talker"],
                                req.text_ids, req.n_text)
                            n_pace = req.n_text
                        self._state = self._insert_assembled(
                            self._state, np.int32(slot), hidden, kv,
                            plen, n_pace, smp.host_prng_key(req.seed),
                            np.int32(self._req_budget(req)))
                except Exception as e:
                    if not req.future.done():
                        req.future.set_exception(e)
                    continue   # slot is still free: try the next request
                self._slot_req[slot] = req
                req.t_admit = time.perf_counter()
                done[slot] = False
                # cloned prefixes are longer: init_state sets pos to
                # prefix_len = n_text + PREFIX_EXTRA + n_ref (review
                # finding: omitting n_ref made the paged top-up
                # under-provision pages at pipeline_depth=2 and silently
                # truncate cloned requests at their page capacity)
                n_ref = req.cloned_prep[1] if req.cloned_prep else 0
                pos[slot] = req.n_text_host + PREFIX_EXTRA + n_ref
                admitted.append(slot)
                break
        return admitted

    def _admit_paged(self, slot: int, req: "_Request") -> bool:
        """Allocate pages for the request's prefix (+ one chunk of
        headroom), prefill into a page-sized dense window, splice into the
        slot. Returns False when the pool can't cover the prefix YET
        (transient — the caller backlogs and retries); raises when the
        prefix can NEVER fit ``max_pages_per_slot`` (an endless backlog
        retry would wedge every request queued behind it)."""
        import dataclasses

        from qwen3_tts_tpu.models.talker import PREFIX_EXTRA

        psz = self.page_size
        free = self._free_by_group[self._slot_group(slot)]
        ref_pad = n_ref = None
        if req.ref_codes is not None:
            ref_pad, n_ref = self._cloned_inputs(
                req, self.max_pages_per_slot * psz)
        p_pad = (int(req.text_ids.shape[0]) + PREFIX_EXTRA
                 + (ref_pad.shape[0] if ref_pad is not None else 0))
        if p_pad > self.max_pages_per_slot * psz:
            raise ValueError(
                f"request prefix ({p_pad} rows incl. {PREFIX_EXTRA} "
                f"special) exceeds a slot's page capacity "
                f"({self.max_pages_per_slot} pages x {psz}); shorten the "
                f"text or raise max_pages_per_slot/page_size")
        need = -(-(p_pad + self.decode_chunk + 2) // psz)
        need = min(need, self.max_pages_per_slot)
        # never-fits: a prefix needing more pages than the group's pool
        # holds even when fully idle would otherwise backlog forever and
        # wedge every request FIFO-queued behind it (the guard above only
        # bounds against max_pages_per_slot, which can exceed a small
        # pool_pages override)
        usable = self._pages_per_group - 1   # one reserved page per group
        if need > usable:
            raise ValueError(
                f"request prefix needs {need} pages but the pool has only "
                f"{usable} usable pages per dp group (pool_pages="
                f"{self.pool_pages}, page_size={psz}); raise pool_pages "
                f"or shorten the text")
        if len(free) < need:
            return False

        s_pre = -(-p_pad // psz) * psz   # dense prefill window, page-aligned
        cloned = ref_pad is not None
        fn = self._prefill_cache.get((s_pre, cloned))
        if fn is None:
            pcfg = dataclasses.replace(
                self.cfg, talker=dataclasses.replace(
                    self.cfg.talker, max_seq_len=s_pre))
            fn = self._prefill_cache[(s_pre, cloned)] = (
                self._make_prefix_cloned(pcfg) if cloned
                else self._make_prefix_plain(pcfg))
        ids_b = np.asarray(req.text_ids).tobytes()
        if cloned:
            hidden, kv, plen = self._prefix_result(
                (ids_b, req.n_text_host, s_pre, True,
                 np.asarray(ref_pad).tobytes(), int(n_ref)),
                fn, self.params["talker"],
                self.params["code_predictor"]["codec_embs"],
                req.text_ids, req.n_text,
                np.asarray(ref_pad), np.int32(n_ref))
            n_pace = np.int32(req.n_target)
        else:
            hidden, kv, plen = self._prefix_result(
                (ids_b, req.n_text_host, s_pre, False),
                fn, self.params["talker"], req.text_ids, req.n_text)
            n_pace = req.n_text

        pages = [free.pop() for _ in range(need)]
        table_row = np.zeros((self.max_pages_per_slot,), np.int32)
        table_row[:need] = pages
        # splice the whole page-aligned prefill window, not just the
        # p_pad true rows: n_rows is a STATIC arg (it shapes the slice),
        # so per-length values would compile one insert program per
        # distinct text length — per s_pre bucket there is exactly one.
        # The rows beyond the prefix land inside the slot's pages but are
        # never read before the decode loop overwrites them (attention is
        # masked to rows <= pos, and the row at pos is written first).
        try:
            self._state = self._insert_assembled_paged(
                self._state, np.int32(slot), hidden, kv, plen, n_pace,
                smp.host_prng_key(req.seed),
                np.int32(self._req_budget(req)),
                table_row, np.int32(need * psz),
                n_rows=s_pre)
        except BaseException:
            # the insert failed before the pages were recorded in
            # _slot_pages: return them to the pool or they leak forever,
            # draining it until every admit backlogs (review finding)
            free.extend(pages)
            raise
        self._slot_pages[slot] = pages
        return True

    def _top_up_pages(self, pos: np.ndarray, done: np.ndarray) -> None:
        """Grow page tables so no active slot hits its capacity inside the
        coming decode chunk (pages allocate between chunks, never inside
        the jitted loop). All of a round's grows batch into ONE jitted
        table/capacity scatter (usually one round suffices: a chunk
        consumes at most one page per slot); the dispatch is async and the
        caller hands in the positions it already fetched (each d2h round
        trip blocks the scheduler)."""
        psz = self.page_size
        while True:
            grows = []  # (slot, table_idx, page) — at most one per slot
            for slot in range(self.batch_size):
                if self._slot_req[slot] is None or done[slot]:
                    continue
                if (len(self._slot_pages[slot]) * psz - int(pos[slot])
                        >= self.pipeline_depth * self.decode_chunk + 2):
                    continue
                if len(self._slot_pages[slot]) >= self.max_pages_per_slot:
                    continue   # slot finishes at capacity
                free = self._free_by_group[self._slot_group(slot)]
                if not free:
                    continue   # pool exhausted: the slot finishes at capacity
                page = free.pop()
                grows.append((slot, len(self._slot_pages[slot]), page))
                self._slot_pages[slot].append(page)
            if not grows:
                return
            G = self.batch_size
            slots = np.full((G,), grows[0][0], np.int32)
            idxs = np.full((G,), grows[0][1], np.int32)
            pages = np.full((G,), grows[0][2], np.int32)
            valid = np.zeros((G,), np.int32)
            for j, (s, i, p) in enumerate(grows):
                slots[j], idxs[j], pages[j], valid[j] = s, i, p, 1
            self._state = self._grow_many(
                self._state, slots, idxs, pages, valid)

    # minimum new tokens per streaming emission while a slot is live
    # (the final emission always flushes). Emissions feed the INCREMENTAL
    # stream (models/vocoder_stream.py): per-emission cost is O(new
    # tokens) regardless of position — a paged long stream pays the same
    # total vocoder work as one full decode (the round-3 full-left-
    # context windows paid O(end) per emission, ~quadratic total). The
    # 48-token pacing still matches the reference client's 64-token
    # cadence (tts_client.py:31, ~4 s of audio per wire frame); the FIRST
    # emission uses a small head threshold so a streaming client's first
    # frame lands after one or two decode chunks (the engine
    # head-schedule analog).
    stream_emit_tokens = 48
    stream_head_tokens = 8

    def _dispatch_stream_windows(self, state, done, n_codes, skip):
        """Per-slot streaming emissions, dispatch phase: advance each
        streaming slot's incremental vocoder stream over its new final
        tokens (decomposed into the fixed STREAM_STEP_SIZES quanta;
        sub-quantum remainders wait for more tokens unless the slot is
        done). The stream's internal hold-back lag (output_crop samples)
        replaces the old one-token lookahead hold-back; a finished slot
        flushes the lag through >= 1 frame of zero codes past the
        utterance end — the same zero-code lookahead contract as
        synthesize_exact, so the concatenated segments equal the
        non-streaming audio (int16 within the vocoder_stream contract).
        Steps dispatch on device values (chained behind the decode
        chunk), before any codes fetch; state threads per request."""
        U = SAMPLES_PER_TOKEN
        crop = self.cfg.vocoder.output_crop
        jobs = []
        for slot in range(self.batch_size):
            req = self._slot_req[slot]
            if req is None or req.on_chunk is None or slot in skip:
                continue
            if not self._owns(slot):
                continue   # multi-process: the owning host streams it
            if req.stream_error is not None:
                # a failed segment fetch left a hole that cannot be
                # re-rendered — emitting later segments would stream audio
                # with a silent gap (review finding); stop emitting and
                # let the finish path surface the error
                continue
            n = int(n_codes[slot])
            if n <= 0:
                continue
            avail = n - req.rendered
            plan = []
            if done[slot]:
                if req.stream_kept >= n * U:
                    continue
                # cover the remaining frames plus >= 1 flush frame (one
                # extra frame yields U > output_crop samples); the last
                # quantum overshoots into the zero rows past n
                need = avail + 1
                while need > 0:
                    s = min((s for s in self.STREAM_STEP_SIZES
                             if s >= need),
                            default=max(self.STREAM_STEP_SIZES))
                    plan.append(s)
                    need -= s
            else:
                min_emit = (self.stream_head_tokens if req.rendered == 0
                            else self.stream_emit_tokens)
                if avail < min_emit:
                    continue
                floor = min(self.STREAM_STEP_SIZES)
                while avail >= floor:
                    s = max(s for s in self.STREAM_STEP_SIZES if s <= avail)
                    plan.append(s)
                    avail -= s
            row = self._codes_row(state, slot) if plan else None
            for c in plan:
                primed = req.voc_stream is not None
                if not primed:
                    req.voc_stream = vstream.init_stream_state(
                        self.cfg.vocoder)
                fut, req.voc_stream = self._stream_step_fn(c, primed)(
                    self.params["vocoder"], row,
                    jnp.int32(req.rendered), req.voc_stream)
                out_len = c * U - (0 if primed else crop)
                keep = out_len
                if done[slot]:
                    keep = min(out_len, n * U - req.stream_kept)
                req.rendered += c
                req.stream_kept += keep
                if keep > 0:
                    jobs.append((req, fut, keep))
        return jobs

    def _harvest(self, state, skip=frozenset(), local_status=None) -> int:
        """Read ``state``'s post-run status, emit streaming windows, and
        resolve finished slots. ``state`` is the run output to harvest —
        the chain tail at pipeline_depth=1, the PREVIOUS chunk's output
        (one behind the tail) at depth 2. ``skip``: slots admitted after
        ``state`` was dispatched (depth 2): the fetched status predates
        their insert, so they are excluded from every per-slot decision
        and keep their admit-time mirror values from ``local_status``."""
        # ONE combined round trip for the post-run status; pos rides along
        # for free and the (done, pos) pair is stashed for the next
        # step()'s admission pass (nothing between here and there mutates
        # them on device: _release/_grow_many only touch kv table state)
        done, n_codes, pos = self._fetch_status(state)
        m_done, m_pos = done.copy(), pos.copy()
        if skip and local_status is not None:
            ld, lp = local_status
            for sl in skip:
                m_done[sl], m_pos[sl] = ld[sl], lp[sl]
        self._status_mirror = (m_done, m_pos)
        now = time.perf_counter()
        streaming_work = False
        for s in range(self.batch_size):
            if s in skip:
                continue
            r = self._slot_req[s]
            if r is not None and r.t_first is None and n_codes[s] > 0:
                r.t_first = now   # first token observed (chunk granularity)
            if r is not None and r.on_chunk is not None and n_codes[s] > 0:
                streaming_work = True
        finished_slots = [s for s in range(self.batch_size)
                          if self._slot_req[s] is not None and done[s]
                          and s not in skip]
        if not finished_slots and not streaming_work:
            return 0
        # dispatch every vocoder window on DEVICE codes first (chained
        # behind the decode chunk), so the codes fetch below overlaps
        # their execution instead of gating their dispatch
        stream_jobs = self._dispatch_stream_windows(state, done, n_codes,
                                                    skip)
        voc_futs = {}
        for slot in finished_slots:
            req = self._slot_req[slot]
            n = int(n_codes[slot])
            if (req.on_chunk is None and 0 < n <= 256
                    and self._owns(slot)):
                voc_futs[slot] = self._voc_slot(
                    self.params["vocoder"], self._codes_row(state, slot),
                    W=voc.voc_bucket(n + 1))
        # start every pending d2h transfer together (slot codes + all
        # dispatched windows): the fetch loops below then drain one
        # overlapped burst instead of paying a round trip per window.
        # (Multi-process: the global codes array is not fully
        # addressable — owned slots were already re-hosted per row by
        # _codes_row above.)
        if finished_slots and not self._multiproc:
            state.codes.copy_to_host_async()
        for _, fut_, _ in stream_jobs:
            fut_.copy_to_host_async()
        for fut_ in voc_futs.values():
            fut_.copy_to_host_async()
        codes_all = (np.asarray(jax.device_get(state.codes))
                     if finished_slots and not self._multiproc else None)
        for req, fut, keep in stream_jobs:
            try:
                seg = np.asarray(fut)[0][:keep]
            except Exception as e:
                # a failed device fetch leaves a hole that cannot be
                # re-rendered (rendered already advanced) — surface it on
                # the request instead of resolving with silent gaps
                req.stream_error = e
                continue
            req.audio_parts.append(seg)
            try:
                req.on_chunk(seg)
            except Exception:
                pass  # a failing consumer must not kill the batch
        finished = 0
        for slot in finished_slots:
            req = self._slot_req[slot]
            if self._multiproc and not self._owns(slot):
                # peer-owned slot: the owning host vocodes and serves its
                # client; here it resolves to the remote marker so the
                # lockstep frontend's local Future never hangs. Pages /
                # device bookkeeping below still run (identical global
                # dispatch sequence on every process).
                req.t_done = time.perf_counter()
                if not req.future.done():
                    req.future.set_result((None, None))
                self._slot_req[slot] = None
                if self.paged:
                    self._state = self._release(self._state,
                                                np.int32(slot))
                    self._free_by_group[self._slot_group(slot)].extend(
                        self._slot_pages[slot])
                    self._slot_pages[slot] = []
                finished += 1
                continue
            n = int(n_codes[slot])
            codes = (codes_all[slot][:n] if codes_all is not None
                     else np.asarray(self._codes_row(state, slot))[:n])
            try:
                # same audio as the CLI/engine for the same codes: the
                # exact bucketed (device-windowed) / left-context path
                # (round-2 VERDICT Weak #2 — crossfade blending stays
                # wire-compat-only, serve/compat.py)
                if req.on_chunk is not None:
                    if req.stream_error is not None:
                        raise req.stream_error
                    # streamed slots already rendered everything through
                    # the exact windows; the blob result is their concat
                    audio = (np.concatenate(req.audio_parts)
                             if req.audio_parts
                             else np.zeros((0,), np.int16))
                elif slot in voc_futs:
                    audio = np.asarray(voc_futs[slot])[0][
                        :n * SAMPLES_PER_TOKEN]
                elif n == 0:
                    # keep submit()'s int16 contract even for an
                    # immediate-EOS request (synthesize_exact's n==0
                    # early-exit returns float32)
                    audio = np.zeros((0,), np.int16)
                else:  # > 256 tokens
                    audio = voc.synthesize_exact(
                        lambda ch: self._voc(self.params["vocoder"],
                                             jnp.asarray(ch)),
                        codes)
                req.t_done = time.perf_counter()
                req.future.set_result((codes, audio))
            except Exception as e:
                req.t_done = time.perf_counter()
                req.future.set_exception(e)
            self._slot_req[slot] = None
            if self.paged:
                self._state = self._release(self._state, np.int32(slot))
                self._free_by_group[self._slot_group(slot)].extend(
                    self._slot_pages[slot])
                self._slot_pages[slot] = []
            finished += 1
        return finished

    def step(self) -> bool:
        """One scheduler iteration. Returns True if any work happened.

        ONE blocking round trip per chunk (the harvest's post-run status,
        which also stashes the (done, pos) mirrors this step's admission
        pass consumes — no pre-run fetch): admissions update the host
        mirrors in place, and the prefill / insert / page grow / decode
        dispatches are all async — so host scheduling work overlaps the
        device's decode chunk instead of serializing with it. At
        pipeline_depth=2 even that round trip overlaps compute: the next
        chunk is dispatched before the previous chunk's harvest, and the
        harvest excludes this step's admissions (the fetched status
        predates their insert)."""
        if self._status_mirror is not None:
            done, pos = self._status_mirror
            self._status_mirror = None
        else:
            done, _, pos = self._fetch_status(self._state)
        cancelled = self._evict_cancelled(done)
        admitted = self._admit(done, pos)
        busy = any(r is not None for r in self._slot_req)
        if busy:
            if self.paged:
                self._top_up_pages(pos, done)
            new = self._run(self.params["talker"],
                            self.params["code_predictor"],
                            self._state)
            self._state = new
            if self.pipeline_depth == 1:
                self._harvest(new)
            else:
                # speculative chunk pipelining: the NEXT chunk is already
                # dispatched above, so this harvest's blocking status
                # fetch (which waits for the PREVIOUS chunk) overlaps
                # device compute instead of stalling it
                prev, self._pending = self._pending, new
                if prev is not None:
                    self._harvest(prev,
                                  skip=frozenset(admitted) | cancelled,
                                  local_status=(done, pos))
            return True
        # idle: nothing was admitted (any admission sets _slot_req, which
        # makes busy True above) and nothing ran, so the mirrors still
        # describe the device state — keep them for the next poll instead
        # of paying a fetch every idle iteration (the drained speculative
        # chunk, if any, was a frozen no-op: all slots were done)
        self._pending = None
        self._status_mirror = (done, pos)
        return False

    def _loop(self) -> None:
        # an unexpected step() error (device fault, harvest bug) must not
        # silently kill the scheduler thread — that would leave every
        # Future pending until its client times out. Fail the in-flight
        # slots (their device state is suspect), keep queued requests,
        # and continue; after 3 consecutive failures assume the fault is
        # persistent, fail everything, and halt.
        consecutive = 0
        while not self._stop.is_set():
            try:
                worked = self.step()
                consecutive = 0
            except Exception as e:
                import traceback
                traceback.print_exc()
                consecutive += 1
                self._abort_inflight(e, drain_queue=consecutive >= 3)
                if consecutive >= 3:
                    # close BEFORE the final queue drain: a submit either
                    # lands in the queue in time to be failed below, or
                    # observes _closed and fails fast — without this,
                    # post-halt submits would enqueue Futures that no
                    # thread will ever resolve
                    with self._submit_lock:
                        self._closed = True
                    self._stop.set()
                    self._abort_inflight(e, drain_queue=True)
                    print("batcher: 3 consecutive scheduler failures; "
                          "halting", file=sys.stderr)
                    return
                time.sleep(0.05)
                continue
            if not worked:
                time.sleep(0.002)

    def _abort_inflight(self, exc: Exception, drain_queue: bool) -> None:
        """Self-heal after a scheduler-step failure: fail the in-flight
        slots' Futures, release their pages, and mark them done on device
        so admission can recycle them. Queued/backlogged requests survive
        (the healed scheduler retries them) unless ``drain_queue``."""
        self._status_mirror = None   # device state is suspect / about to change
        self._pending = None
        inflight = [s for s in range(self.batch_size)
                    if self._slot_req[s] is not None]
        for s in inflight:
            r = self._slot_req[s]
            if not r.future.done():
                r.future.set_exception(exc)
            self._slot_req[s] = None
            if self.paged and self._slot_pages[s]:
                try:
                    self._state = self._release(self._state, jnp.int32(s))
                except Exception:
                    # device release failed: the abandoned slot's table
                    # row still points at these pages, and a frozen slot
                    # keeps rewriting K/V at its last position — recycling
                    # them would hand corrupted pages to the next request.
                    # Leak them instead (bounded by slots x pages; the
                    # halt path handles a truly dead device).
                    self._slot_pages[s] = []
                    continue
                self._free_by_group[self._slot_group(s)].extend(
                    self._slot_pages[s])
                self._slot_pages[s] = []
        if inflight:
            mask = np.zeros((self.batch_size,), bool)
            mask[inflight] = True
            try:
                self._state = self._mark_done(self._state,
                                              mask)
            except Exception:
                pass
        if drain_queue:
            leftovers = list(self._waiting) + list(self._backlog)
            self._waiting = []
            self._backlog = []
            while True:
                try:
                    leftovers.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            for r in leftovers:
                if not r.future.done():
                    r.future.set_exception(exc)
