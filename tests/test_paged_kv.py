"""Block-paged KV cache tests (SURVEY §7 hard part 4): paged decode
parity vs the dense cache, paged attention vs dense attention at page
boundaries, and the paged continuous batcher serving a generation LONGER
than the dense allocation allows."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.config import tiny_tts_config
from qwen3_tts_tpu.models import transformer as tfm

GEO = tfm.TransformerGeometry(
    num_layers=2, hidden_size=64, intermediate_size=128,
    num_heads=8, num_kv_heads=4, head_dim=16,
    rms_norm_eps=1e-6, rope_theta=1e6)


def _scrambled_paged(dense_kv, pos, psz, n_pages, maxp):
    """Build a PagedKV holding the same logical rows as ``dense_kv``
    through a deliberately non-contiguous page table."""
    L, _, B, S, Hkv, Dh = dense_kv.shape
    rng = np.random.default_rng(0)
    pages_needed = B * (S // psz)
    perm = rng.permutation(np.arange(1, n_pages))[:pages_needed]
    table = np.zeros((B, maxp), np.int32)
    pool = np.zeros((L, 2, n_pages, psz, Hkv, Dh), np.float32)
    k = 0
    for b in range(B):
        for j in range(S // psz):
            pid = int(perm[k]); k += 1
            table[b, j] = pid
            pool[:, :, pid] = np.asarray(
                dense_kv[:, :, b, j * psz:(j + 1) * psz]).transpose(
                    0, 1, 2, 3, 4)
    return tfm.PagedKV(pool=jnp.asarray(pool), table=jnp.asarray(table),
                       capacity=jnp.full((B,), S, jnp.int32))


def test_paged_decode_step_matches_dense():
    """paged_decode_step == decode_step when the pages hold the same rows
    (scrambled, non-contiguous table)."""
    params = tfm.init_stack_params(jax.random.PRNGKey(0), GEO)
    B, S, psz = 3, 32, 8
    x = jax.random.normal(jax.random.PRNGKey(1), (B, 64)) * 0.3
    pos = jnp.array([5, 13, 26], jnp.int32)
    dense = jax.random.normal(
        jax.random.PRNGKey(2), (2, 2, B, S, 4, 16)) * 0.2
    # zero rows beyond pos like a real cache (they are masked either way)
    want_h, want_kv = tfm.decode_step(params, x, pos, dense, GEO)

    paged = _scrambled_paged(dense, pos, psz, n_pages=64, maxp=S // psz)
    got_h, got_paged = tfm.paged_decode_step(params, x, pos, paged, GEO)
    np.testing.assert_allclose(np.asarray(got_h), np.asarray(want_h),
                               rtol=2e-5, atol=2e-6)

    # the written K/V rows must land at (table[pos//psz], pos%psz) and
    # equal the dense cache's written rows
    for b in range(B):
        p = int(pos[b])
        pid = int(paged.table[b, p // psz])
        np.testing.assert_allclose(
            np.asarray(got_paged.pool[:, :, pid, p % psz]),
            np.asarray(want_kv[:, :, b, p]), rtol=1e-6, atol=1e-7)


def test_gqa_attention_position_bound():
    """Decode attention reads rows [0 .. pos] only: whatever sits past a
    slot's position (stale rows of a recycled slot, unallocated pages)
    cannot change its output."""
    rng = np.random.default_rng(3)
    B, Hq, Hkv, Dh, S = 2, 8, 4, 16, 24
    geo = tfm.TransformerGeometry.attention_only(Hq, Hkv, Dh)
    q = jnp.asarray(rng.normal(size=(B, 1, Hq, Dh)), jnp.float32)
    k = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    pos = np.array([5, 17], np.int32)
    mask = jnp.asarray(np.arange(S)[None, :] <= pos[:, None])[:, None, :]
    want = tfm.gqa_attention(q, jnp.asarray(k), jnp.asarray(v), mask, geo)
    for b in range(B):
        k[b, pos[b] + 1:] = 1e4
        v[b, pos[b] + 1:] = -1e4
    got = tfm.gqa_attention(q, jnp.asarray(k), jnp.asarray(v), mask, geo)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("psz", [4, 8, 16])
def test_paged_attention_matches_dense_at_page_boundaries(psz):
    """paged_decode_attention over a scrambled page table equals dense
    attention over the same logical rows, for positions on each side of
    a page boundary (the last row of a page, the first of the next)."""
    rng = np.random.default_rng(psz)
    Hq, Hkv, Dh, MAXP = 8, 4, 16, 4
    S = MAXP * psz
    pos = np.array([psz - 1, psz, 2 * psz - 1, 2 * psz, S - 1], np.int32)
    B = len(pos)
    n_pages = 1 + B * MAXP
    dense = rng.normal(size=(2, B, S, Hkv, Dh)).astype(np.float32)
    table = (1 + rng.permutation(B * MAXP)).reshape(B, MAXP).astype(np.int32)
    pool = np.zeros((2, n_pages, psz, Hkv, Dh), np.float32)
    for b in range(B):
        for j in range(MAXP):
            pool[:, table[b, j]] = dense[:, b, j * psz:(j + 1) * psz]
    q = jnp.asarray(rng.normal(size=(B, Hq, Dh)), jnp.float32)
    geo = tfm.TransformerGeometry.attention_only(Hq, Hkv, Dh)
    mask = jnp.asarray(np.arange(S)[None, :] <= pos[:, None])[:, None, :]
    want = tfm.gqa_attention(q[:, None], jnp.asarray(dense[0]),
                             jnp.asarray(dense[1]), mask, geo)[:, 0]
    got = tfm.paged_decode_attention(q, jnp.asarray(pool),
                                     jnp.asarray(table), jnp.asarray(pos))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def _paged_batcher(cfg, params, **kw):
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher
    return ContinuousBatcher(cfg, params, dtype=jnp.float32, paged=True,
                             **kw)


@pytest.fixture(scope="module")
def long_cfg_params():
    from qwen3_tts_tpu.io import weights as weights_io

    base = tiny_tts_config(max_tokens=100)
    talker = dataclasses.replace(base.talker, max_seq_len=64)
    cfg = dataclasses.replace(base, talker=talker)
    params = weights_io.init_random_params(cfg, seed=0, dtype=jnp.float32)
    return cfg, params


def test_paged_batcher_exceeds_dense_cap(long_cfg_params):
    """A request must generate PAST the dense allocation: with
    max_seq_len=64 the dense cache caps generation at 64 - prefix rows;
    the paged batcher (page tables grown between chunks) runs to EOS /
    max_tokens."""
    cfg, params = long_cfg_params
    from qwen3_tts_tpu.models.talker import PREFIX_EXTRA

    b = _paged_batcher(cfg, params, batch_size=2, decode_chunk=8,
                       page_size=16)
    ids = np.arange(1000, 1030, dtype=np.int32)  # 30 text tokens
    n_text = 30
    p_pad = len(ids) + PREFIX_EXTRA
    dense_cap = cfg.talker.max_seq_len - 1 - p_pad  # dense would stop here

    fut = b.submit(ids, n_text, seed=12)
    for _ in range(600):
        if fut.done():
            break
        b.step()
    codes, audio = fut.result(timeout=1)
    assert len(codes) > dense_cap, (len(codes), dense_cap)
    assert (codes < 2048).all() and codes.shape[1] == 16
    assert len(audio) == len(codes) * 1920

    # pages recycled at harvest
    assert b._slot_pages[0] == [] and b._slot_pages[1] == []
    assert len(b._free_pages) == b.pool_pages - 1


def test_paged_batcher_deterministic_and_concurrent(long_cfg_params):
    """Same seed => same codes through the paged scheduler, including with
    a second concurrent request in flight (page tables independent)."""
    cfg, params = long_cfg_params
    b = _paged_batcher(cfg, params, batch_size=2, decode_chunk=8,
                       page_size=16)
    ids1 = np.arange(500, 512, dtype=np.int32)
    ids2 = np.arange(700, 720, dtype=np.int32)

    f1 = b.submit(ids1, 12, seed=5)
    f2 = b.submit(ids2, 20, seed=6)
    for _ in range(600):
        if f1.done() and f2.done():
            break
        b.step()
    c1, _ = f1.result(timeout=1)
    c2, _ = f2.result(timeout=1)

    f1b = b.submit(ids1, 12, seed=5)
    for _ in range(600):
        if f1b.done():
            break
        b.step()
    c1b, _ = f1b.result(timeout=1)
    np.testing.assert_array_equal(c1, c1b)
    assert len(c2) > 0


def test_paged_batcher_on_mesh(long_cfg_params):
    """Paged KV on the dp x tp mesh: pages shard over dp as per-group
    sub-pools, kv heads over tp; the shard_map'd attention
    (tfm._paged_write_attend_local) must serve requests past the dense
    cap exactly like the single-chip paged path does, with page
    allocation confined to each slot's dp group."""
    from qwen3_tts_tpu.parallel import mesh as pmesh

    cfg, params = long_cfg_params
    # tiny geometry has 2 kv heads -> tp=2 is the max that divides evenly
    mesh = pmesh.make_mesh(2, 2)
    with mesh:
        b = _paged_batcher(cfg, params, batch_size=2, decode_chunk=8,
                           page_size=16, mesh=mesh)
        ids1 = np.arange(1000, 1030, dtype=np.int32)   # 30 text tokens
        ids2 = np.arange(700, 715, dtype=np.int32)
        f1 = b.submit(ids1, 30, seed=12)
        f2 = b.submit(ids2, 15, seed=6)
        for _ in range(600):
            if f1.done() and f2.done():
                break
            b.step()
        c1, a1 = f1.result(timeout=1)
        c2, a2 = f2.result(timeout=1)

    from qwen3_tts_tpu.models.talker import PREFIX_EXTRA
    dense_cap = cfg.talker.max_seq_len - 1 - (30 + PREFIX_EXTRA)
    assert len(c1) > dense_cap, (len(c1), dense_cap)
    assert (c1 < 2048).all() and c1.shape[1] == 16
    assert len(a1) == len(c1) * 1920 and len(a2) == len(c2) * 1920

    # slot 0 (group 0) and slot 1 (group 1) drew pages from disjoint
    # per-group ranges; all recycled at harvest
    assert b._n_groups == 2
    for g, free in enumerate(b._free_by_group):
        lo, hi = g * b._pages_per_group, (g + 1) * b._pages_per_group
        assert sorted(free) == list(range(lo + 1, hi))


def test_paged_oversized_prefix_fails_not_wedges(long_cfg_params):
    """A prefix that can NEVER fit max_pages_per_slot must fail its own
    Future immediately — the old behavior backlogged it forever, wedging
    every request queued behind it (head-of-line deadlock)."""
    cfg, params = long_cfg_params
    b = _paged_batcher(cfg, params, batch_size=2, decode_chunk=8,
                       page_size=16, max_pages_per_slot=2)  # cap: 32 rows
    too_long = np.arange(100, 140, dtype=np.int32)   # 40 + PREFIX_EXTRA
    f_bad = b.submit(too_long, len(too_long), seed=1)
    f_ok = b.submit(np.arange(200, 212, dtype=np.int32), 12, seed=2)
    for _ in range(600):
        if f_bad.done() and f_ok.done():
            break
        b.step()
    import pytest
    with pytest.raises(ValueError, match="page capacity"):
        f_bad.result(timeout=1)
    codes, audio = f_ok.result(timeout=1)
    assert len(audio) == len(codes) * 1920


def test_paged_pool_exhaustion_degrades_gracefully(long_cfg_params):
    """With a deliberately tiny pool, a long request finishes at its page
    capacity instead of erroring, and the pool is recycled after."""
    cfg, params = long_cfg_params
    b = _paged_batcher(cfg, params, batch_size=1, decode_chunk=8,
                       page_size=16, pool_pages=5)  # 4 usable pages = 64 rows
    ids = np.arange(100, 130, dtype=np.int32)
    fut = b.submit(ids, 30, seed=12)
    for _ in range(400):
        if fut.done():
            break
        b.step()
    codes, audio = fut.result(timeout=1)
    assert len(audio) == len(codes) * 1920
    assert len(b._free_pages) == 4


def test_paged_batcher_streaming_matches_blob(long_cfg_params):
    """Streaming on the PAGED batcher: the conv-exact windows come off
    the (unpaged) codes buffer, so segments must concatenate to the same
    audio a non-streaming paged request produces for the same seed."""
    cfg, params = long_cfg_params
    b = _paged_batcher(cfg, params, batch_size=2, decode_chunk=8,
                       page_size=16)
    ids = np.arange(1000, 1020, dtype=np.int32)
    segs = []
    f_stream = b.submit(ids, 20, seed=31, on_chunk=segs.append)
    f_blob = b.submit(ids, 20, seed=31)
    for _ in range(600):
        if f_stream.done() and f_blob.done():
            break
        b.step()
    codes_s, audio_s = f_stream.result(timeout=1)
    codes_b, audio_b = f_blob.result(timeout=1)
    np.testing.assert_array_equal(codes_s, codes_b)
    np.testing.assert_array_equal(audio_s, audio_b)
    assert segs and np.testing.assert_array_equal(
        np.concatenate(segs), audio_s) is None


def test_paged_never_fits_pool_raises(long_cfg_params):
    """A prefix needing more pages than the group's pool holds even when
    fully idle must fail ITS OWN Future with a clear error instead of
    backlogging forever (which would also wedge every request queued
    behind it); a small request behind it must still be served."""
    cfg, params = long_cfg_params
    # pool_pages=3 -> 2 usable pages = 32 rows; a 30-token text needs
    # ceil((39 + 8 + 2) / 16) = 4 pages
    b = _paged_batcher(cfg, params, batch_size=1, decode_chunk=8,
                       page_size=16, pool_pages=3)
    f_bad = b.submit(np.arange(100, 130, dtype=np.int32), 30, seed=1)
    f_ok = b.submit(np.arange(5, dtype=np.int32), 5, seed=2)
    for _ in range(400):
        if f_bad.done() and f_ok.done():
            break
        b.step()
    with pytest.raises(ValueError, match="usable pages per dp group"):
        f_bad.result(timeout=1)
    codes, audio = f_ok.result(timeout=1)
    assert len(audio) == len(codes) * 1920
    assert len(b._free_pages) == 2   # fully recycled


def test_paged_local_table_guard_routes_bad_ids_to_sink():
    """An out-of-range global page id in the table (allocation bug, or a
    stale entry above the group's range) must route writes to the group's
    reserved sink (local page 0), never to a live page. The pre-guard
    code clipped to p_local-1, so an above-range id silently overwrote
    another slot's newest KV page (round-3 review finding)."""
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from qwen3_tts_tpu.parallel import mesh as pmesh

    psz, p_local, Hq, Hkv, Dh = 4, 4, 2, 1, 8
    B, maxp = 2, 3                       # one slot per dp group
    mesh = pmesh.make_mesh(2, 1)
    rng = np.random.default_rng(7)
    q1 = jnp.asarray(rng.normal(size=(B, Hq, Dh)).astype(np.float32))
    new_kv = jnp.asarray(rng.normal(size=(2, B, Hkv, Dh)).astype(np.float32))
    pool = jnp.asarray(rng.normal(
        size=(2, 2 * p_local, psz, Hkv, Dh)).astype(np.float32))
    # slot 0 (group 0): healthy table inside [0, 4).
    # slot 1 (group 1): current page id 13 is ABOVE every group's range.
    table = jnp.asarray(np.array([[1, 2, 0], [13, 0, 0]], np.int32))
    pos = jnp.array([5, 2], jnp.int32)   # slot0 -> page idx 1, row 1

    fn = jax.shard_map(
        partial(tfm._paged_write_attend_local, psz=psz, p_local=p_local),
        mesh=mesh,
        in_specs=(P("dp", "tp", None), P(None, "dp", "tp", None),
                  P(None, "dp", None, "tp", None), P("dp", None), P("dp")),
        out_specs=(P("dp", "tp"), P(None, "dp", None, "tp", None)),
        check_vma=False)
    attn, new_pool = fn(q1, new_kv, pool, table, pos)
    new_pool = np.asarray(new_pool)

    # slot 0's write landed at (global page 2, row 1)
    np.testing.assert_array_equal(new_pool[:, 2, 1, 0],
                                  np.asarray(new_kv[:, 0, 0]))
    # slot 1's bad id landed in group 1's sink (global page 4, row 2) —
    # NOT in group 1's last live page (global 7, where a clip sent it)
    np.testing.assert_array_equal(new_pool[:, 4, 2, 0],
                                  np.asarray(new_kv[:, 1, 0]))
    untouched = np.asarray(pool)
    for g_page in (5, 6, 7, 0, 1, 3):
        np.testing.assert_array_equal(new_pool[:, g_page],
                                      untouched[:, g_page])
    assert np.isfinite(np.asarray(attn)).all()
