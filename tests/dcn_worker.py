"""Worker process for the two-process DCN integration test
(test_multihost.test_two_process_dcn_integration — launched as a
subprocess, NOT collected by pytest).

Each process: 4 virtual CPU devices; jax.distributed over the gloo CPU
collectives backend; the framework's own init path
(multihost.init_distributed from QWEN3_TTS_* env) and serving mesh
(make_serving_mesh: tp confined to one process, dp host-major); then the
REAL fused prefill+decode program (engine/generate.run_steps) jitted
over the global 2x4 mesh — cross-process dp, in-process tp collectives —
exactly the placement rule the module documents.
"""
import dataclasses

import numpy as np
import jax

jax.config.update("jax_cpu_collectives_implementation", "gloo")
import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.engine import generate as gen
from qwen3_tts_tpu.io import weights as weights_io
from qwen3_tts_tpu.models import talker as tk
from qwen3_tts_tpu.parallel import mesh as pmesh
from qwen3_tts_tpu.parallel import multihost as mh


def main() -> None:
    assert mh.init_distributed(), "QWEN3_TTS_* env must trigger init"
    pid = jax.process_index()
    assert jax.process_count() == 2 and len(jax.devices()) == 8
    print(f"p{pid} init ok", flush=True)

    mesh = mh.make_serving_mesh(tp=4)
    # the placement rule the module exists for: a tp row never crosses a
    # process boundary (tp collectives must ride intra-host links)
    for dp_row in mesh.devices:
        assert len({d.process_index for d in dp_row}) == 1
    print(f"p{pid} mesh ok dp{mesh.shape['dp']}xtp{mesh.shape['tp']}",
          flush=True)

    talker = C.TalkerConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=8, num_kv_heads=4, head_dim=16,
        text_vocab_size=151936, text_embed_dim=64, codec_vocab_size=3072,
        max_seq_len=64)
    cp = C.CodePredictorConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=8, num_kv_heads=4, head_dim=16)
    cfg = dataclasses.replace(C.tiny_tts_config(max_tokens=4),
                              talker=talker, code_predictor=cp)
    # params are created as COMMITTED global arrays by a jitted init with
    # out_shardings — never device_put from host values: in
    # multi-controller JAX, device_put of an uncommitted value to a
    # multi-process sharding runs multihost_utils.assert_equal, a GLOO
    # allgather whose context-init rendezvous has a hardcoded ~30 s
    # deadline; under CPU contention the peers' compile skew blows it
    # (observed round-4: "Gloo context initialization failed:
    # GetKeyValue() timed out", jax/_src/dispatch.py:493). The jitted
    # init executes locally on every process (same seed => same values),
    # no cross-process traffic at all.
    def init_tkcp():
        p = weights_io.init_random_params(cfg, seed=0, dtype=jnp.float32)
        return {"talker": p["talker"],
                "code_predictor": p["code_predictor"]}

    abs_params = jax.eval_shape(init_tkcp)
    param_sh = pmesh.param_shardings(mesh, abs_params)

    from jax.sharding import NamedSharding
    B = 2 * mesh.shape["dp"]
    state_spec = pmesh.gen_state_spec(cfg)
    state_shardings = jax.tree.map(
        lambda s: NamedSharding(mesh, s), state_spec,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))

    @jax.jit
    def prefill_and_step(tkp, cpp):
        # inputs derived from literals IN-PROGRAM (host-value args would
        # re-enter the assert_equal path above)
        ids = jnp.tile(jnp.arange(8, dtype=jnp.int32)[None], (B, 1))
        n_text = jnp.full((B,), 5, jnp.int32)
        key = jax.random.PRNGKey(0)
        prefix, plen = jax.vmap(
            lambda i, n: tk.build_prefix(tkp, i, n))(ids, n_text)
        state = gen.init_state(tkp, prefix, plen, n_text, key, cfg)
        state = jax.lax.with_sharding_constraint(state, state_shardings)
        state = gen.run_steps(tkp, cpp, state, cfg, max_steps=2)
        return state.codes, state.n_codes

    with mesh:
        # AOT-compile BEFORE any cross-process execution, then fence on
        # the coordination-service barrier: cold compiles run minutes and
        # are unsynchronized across processes, and a process that starts
        # executing (blocking in a gloo collective) while its peer still
        # compiles blows the transport timeout (round-3 flake). The
        # coordination barrier waits the full timeout regardless.
        init_c = jax.jit(init_tkcp, out_shardings=param_sh).lower().compile()
        abs_in = jax.tree.map(
            lambda a, s: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=s),
            abs_params, param_sh)
        compiled = prefill_and_step.lower(abs_in["talker"],
                                          abs_in["code_predictor"]).compile()
        # The result gather must be AOT-compiled too:
        # multihost_utils.process_allgather compiles its pjit AT CALL
        # TIME, so under CPU contention the two processes' compile skew
        # lands inside the call — and gloo's context-init rendezvous has
        # a hardcoded ~30 s deadline that starts at execution (observed:
        # "Gloo context initialization failed: GetKeyValue() timed out").
        # One identity pjit replicating both outputs = one gloo
        # rendezvous, compiled before the fence.
        rep = NamedSharding(mesh, jax.sharding.PartitionSpec())
        csh, nsh = compiled.output_shardings
        gather = jax.jit(lambda c, n: (c, n), out_shardings=(rep, rep))
        gather_c = gather.lower(
            jax.ShapeDtypeStruct((B, cfg.max_tokens, 16), jnp.int32,
                                 sharding=csh),
            jax.ShapeDtypeStruct((B,), jnp.int32, sharding=nsh),
        ).compile()
        print(f"p{pid} compiled", flush=True)
        mh.barrier("dcn_worker_compiled", timeout_s=900)
        # all executions run back-to-back after the fence: skew between
        # processes is now execution time on tiny shapes (ms), far inside
        # any transport rendezvous deadline
        sharded = init_c()
        codes, n_codes = compiled(sharded["talker"],
                                  sharded["code_predictor"])
        codes_all, n_all = gather_c(codes, n_codes)
    n_all = np.asarray(n_all.addressable_data(0))
    codes_all = np.asarray(codes_all.addressable_data(0))
    assert codes_all.shape == (B, cfg.max_tokens, 16)
    assert (codes_all[:, :2] < cfg.code_predictor.group_vocab_size).all()
    print(f"pRESULT {pid} n_codes={n_all.tolist()} "
          f"codes_sum={int(codes_all.sum())}", flush=True)
    # explicit final fence + shutdown: never rely on the atexit barrier
    # (its skew budget is the whole reason this worker fences phases)
    mh.barrier("dcn_worker_done", timeout_s=900)
    mh.shutdown_distributed()


if __name__ == "__main__":
    main()
