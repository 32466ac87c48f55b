"""The port's Predictor (``paddle_tpu_torch.inference``) against the JAX
package's, on the CPU.

Weights cross by the JAX package's own export files: JAX builds a model,
runs its startup and ``save_inference_model`` (or the reference
``__model__`` layout), and the Predictors of both packages load that one
directory. The port's Predictor is asked for the CPU with
``AnalysisConfig.disable_gpu()``. Tolerances: f32 at rtol 1e-5, atol
1e-6 (the JAX tests' own); the two bf16 Predictors of the fc net within
``BF16_FC_ATOL``.

Twins of ``tests/io/test_predictor.py`` (the four Predictor tests),
``tests/api/test_quant_serving.py:395,440`` (``enable_int8`` on the
Program path and in generation), ``tests/api/test_serving_engine.py:380,
406`` (``generation_server`` and its raise) and
``tests/api/test_amp_fleet_utils.py:74`` (``utils.model_stat``), and the
repairs of ROADMAP C23: bf16 parameters under f32 activations through
``layer_norm``, ``mul`` and ``matmul``, which torch refuses and ``jnp``
promotes to f32.

The JAX ``GenerationServer`` cannot step on jax 0.9 (ROADMAP
C, reference-side facts), so the generation twins hold the port's
Predictor server to the JAX dense-cache reference decode
(``_jax_reference_greedy``, ``test_serving_engine.py``'s
``_reference_greedy``) and to a port server built directly from the same
parameters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu import layers as jlayers
from paddle_tpu.core import framework as jframework
from paddle_tpu.inference import decoding as jdec
from paddle_tpu.models import gpt as jgpt
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability.metrics import global_registry
from paddle_tpu_torch.serving import GenerationServer, GPTServingModel

RTOL, ATOL = 1e-5, 1e-6
# the two bf16 Predictors of the fc net: its f32 feed promotes the bf16
# weights, so both packages compute the same f32 products (measured
# 6e-8); BERT's bf16 activations differ more (tests/test_torch_inference_
# tp.py's 2e-2)
BF16_FC_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: the suite runs several pytest
    workers at once (see tests/test_torch_quant.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _port(model_dir):
    return tinference.AnalysisConfig(model_dir).disable_gpu()


def _fc_net(fluid, layers, framework):
    main, startup = framework.Program(), framework.Program()
    with fluid.unique_name.guard(), framework.program_guard(main, startup):
        x = fluid.data(name="x", shape=[-1, 8], dtype="float32")
        h = layers.fc(x, size=16, act="relu")
        pred = layers.fc(h, size=3, act="softmax")
    return main, startup, pred


def _save_model(tmp_path, reference_layout=False, seed=0):
    """JAX exports the fc net (test_predictor.py's _save_model): (dir,
    input, JAX training-forward output)."""
    main, startup, pred = _fc_net(jfluid, jlayers, jframework)
    exe = jfluid.Executor()
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        path = str(tmp_path / ("ref" if reference_layout else "m"))
        if reference_layout:
            jfluid.io.save_fluid_inference_model(path, ["x"], [pred], exe,
                                                 main_program=main)
        else:
            jfluid.io.save_inference_model(path, ["x"], [pred], exe,
                                           main_program=main)
        ref_in = np.random.default_rng(seed).standard_normal(
            (4, 8)).astype(np.float32)
        ref_out = np.asarray(exe.run(main.clone(for_test=True),
                                     feed={"x": ref_in},
                                     fetch_list=[pred])[0])
    return path, ref_in, ref_out


# ---------------------------------------------------------------------------
# tests/io/test_predictor.py
# ---------------------------------------------------------------------------

def test_predictor_matches_training_forward(tmp_path):
    model_dir, ref_in, ref_out = _save_model(tmp_path)
    predictor = tinference.create_predictor(_port(model_dir))
    assert predictor.device.type == "cpu"
    out = predictor.run({"x": ref_in})
    np.testing.assert_allclose(out[0], ref_out, rtol=RTOL, atol=ATOL)
    # positional-list feeds work too (ZeroCopy parity)
    out2 = predictor([ref_in])
    np.testing.assert_allclose(out2[0], ref_out, rtol=RTOL, atol=ATOL)
    jout = jinference.create_predictor(model_dir).run({"x": ref_in})
    np.testing.assert_allclose(out[0], np.asarray(jout[0]), rtol=RTOL,
                               atol=ATOL)


def test_predictor_bucket_padding(tmp_path):
    model_dir, ref_in, ref_out = _save_model(tmp_path)
    predictor = tinference.create_predictor(
        _port(model_dir).set_batch_buckets([4, 8]))
    # batch of 3 pads to bucket 4; only 3 rows come back
    out = predictor.predict_batch({"x": ref_in[:3]})
    assert out[0].shape[0] == 3
    np.testing.assert_allclose(out[0], ref_out[:3], rtol=RTOL, atol=ATOL)
    # past the largest bucket: 12 rows split into 8 + 4, as JAX's does
    big = np.concatenate([ref_in] * 3)
    got = predictor.predict_batch({"x": big})
    jcfg = jinference.AnalysisConfig(model_dir).set_batch_buckets([4, 8])
    want = jinference.create_predictor(jcfg).predict_batch({"x": big})
    assert got[0].shape == (12, 3)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got[0], np.concatenate([ref_out] * 3),
                               rtol=RTOL, atol=ATOL)


def test_predictor_bf16_close_to_fp32(tmp_path):
    model_dir, ref_in, ref_out = _save_model(tmp_path)
    predictor = tinference.create_predictor(_port(model_dir).enable_bf16())
    out = predictor.run({"x": ref_in})[0]
    np.testing.assert_allclose(out, ref_out, rtol=3e-2, atol=3e-2)
    jcfg = jinference.AnalysisConfig(model_dir)
    jcfg.enable_bf16()
    jout = np.asarray(jinference.create_predictor(jcfg).run(
        {"x": ref_in})[0], np.float32)
    np.testing.assert_allclose(out, jout, rtol=0, atol=BF16_FC_ATOL)
    # the scope's floats are bf16, as JAX's _cast_params_bf16 leaves them
    assert {predictor.scope.get(n).dtype
            for n in predictor.scope.names()} == {torch.bfloat16}


def test_predictor_serves_reference_export_dir(tmp_path):
    """A dir in the REFERENCE layout (__model__ protobuf + weights) feeds
    the same Predictor pipeline."""
    model_dir, ref_in, ref_out = _save_model(tmp_path,
                                             reference_layout=True, seed=1)
    predictor = tinference.create_predictor(_port(model_dir))
    assert predictor.get_input_names() == ["x"]
    out = predictor.run({"x": ref_in})
    np.testing.assert_allclose(out[0], ref_out, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# C23: bf16 parameters under f32 activations, op by op
# ---------------------------------------------------------------------------

def _c23_net(fluid, layers, framework, op):
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), framework.program_guard(main, startup):
        x = fluid.data(name="x", shape=[-1, 6, 8], dtype="float32")
        if op == "layer_norm":
            out = layers.layer_norm(x, begin_norm_axis=2)
        elif op == "mul":
            out = layers.fc(x, size=5, num_flatten_dims=2)
        else:
            y = layers.create_parameter([8, 4], "float32", name="c23_y")
            out = layers.matmul(x, y)
    return main, startup, out


@pytest.mark.parametrize("op", ["layer_norm", "mul", "matmul"])
def test_bf16_params_under_f32_activations(op):
    """ROADMAP C23: bf16 parameters under an f32 activation promote to
    f32, as jnp promotes them, instead of raising (the parent raised
    'mixed dtype' in layer_norm and 'expected m1 and m2 to have the same
    dtype' in mul and matmul)."""
    jmain, jstart, jout = _c23_net(jfluid, jlayers, jframework, op)
    tmain, tstart, tout = _c23_net(tfluid, tlayers, tframework, op)
    x = np.random.default_rng(4).standard_normal((3, 6, 8)).astype(
        np.float32)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        for n in jscope.names():
            v = jnp.asarray(jscope.get(n))
            # non-trivial scale and bias, rounded to bf16
            v = v + 0.1 * jnp.arange(v.size, dtype=v.dtype).reshape(
                v.shape) / v.size
            jscope.set(n, v.astype(jnp.bfloat16))
        want = jexe.run(jmain, feed={"x": x}, fetch_list=[jout])[0]
        params = {n: np.asarray(jscope.get(n), np.float32)
                  for n in jscope.names()}
    tscope = tfluid.Scope()
    for n, v in params.items():
        tscope.set(n, torch.from_numpy(v).to(torch.bfloat16))
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = texe.run(tmain, feed={"x": x}, fetch_list=[tout],
                   scope=tscope)[0]
    assert np.asarray(want).dtype == np.float32 and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# tests/api/test_amp_fleet_utils.py:74
# ---------------------------------------------------------------------------

def _stat_net(fluid, layers, framework):
    main, startup = framework.Program(), framework.Program()
    with fluid.unique_name.guard(), framework.program_guard(main, startup):
        x = layers.data("x", shape=[8], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        h = layers.fc(x, size=16, act="relu")
        loss = layers.mean(layers.square_error_cost(layers.fc(h, size=1),
                                                    y))
    return main


def test_model_stat_counts():
    from paddle_tpu.utils import model_stat as jstat
    from paddle_tpu_torch.utils import model_stat
    main = _stat_net(tfluid, tlayers, tframework)
    n, per_param = model_stat.count_params(main)
    assert n == 8 * 16 + 16 + 16 * 1 + 1
    assert per_param["fc_0.w_0"] == 128
    flops, per_op = model_stat.count_flops(main, batch_size=4)
    assert flops >= 2 * 4 * (8 * 16 + 16)
    assert per_op.get("mul", 0) > 0
    jmain = _stat_net(jfluid, jlayers, jframework)
    assert (n, per_param) == jstat.count_params(jmain)
    assert (flops, per_op) == jstat.count_flops(jmain, batch_size=4)
    lines = []
    rep = model_stat.summary(main, batch_size=4, print_fn=lines.append)
    assert rep == {"params": n, "flops": flops, "per_op": per_op}
    assert lines[0] == "params: 0.000 M" and len(lines) == 2 + len(per_op)


# ---------------------------------------------------------------------------
# tests/api/test_quant_serving.py:395 — enable_int8 on the Program path
# ---------------------------------------------------------------------------

def _mlp(fluid, layers, framework):
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), framework.program_guard(main, startup):
        x = layers.data("x", shape=[8], dtype="float32")
        h = layers.fc(x, size=16, act="relu")
        out = layers.fc(h, size=4)
    return main, startup, out


def test_enable_int8_program_path_accuracy_and_metrics(tmp_path):
    main, startup, out = _mlp(jfluid, jlayers, jframework)
    exe = jfluid.Executor()
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(str(tmp_path / "mlp"), ["x"],
                                       [out], exe, main_program=main)
    rng = np.random.default_rng(0)
    feeds = [{"x": rng.standard_normal((4, 8)).astype(np.float32)}
             for _ in range(4)]
    ref = tinference.create_predictor(_port(str(tmp_path / "mlp"))).run(
        feeds[0])[0]
    reg = global_registry()
    w0 = reg.counter("inference.int8.weights").value()
    a0 = reg.counter("inference.int8.calibrated_activations").value()
    p_q = tinference.create_predictor(
        _port(str(tmp_path / "mlp")).enable_int8(calibration_feeds=feeds))
    got = p_q.run(feeds[0])[0]
    assert p_q.int8_weight_tensors == 2        # both fc weights
    assert p_q.int8_calibrated_activations >= 1
    assert reg.counter("inference.int8.weights").value() == \
        w0 + p_q.int8_weight_tensors
    assert reg.counter(
        "inference.int8.calibrated_activations").value() == \
        a0 + p_q.int8_calibrated_activations
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 0.1, rel
    # per-channel: the inserted weight quant op carries quant_axis=1
    qops = [op for op in p_q.program.global_block().ops
            if op.type.startswith("fake_channel_wise_quantize")]
    assert qops and all(op.attr("quant_axis") == 1 for op in qops)
    # the JAX Predictor's int8 rewrite of the same export: the same
    # rewritten ops, the same output
    jq = jinference.create_predictor(
        jinference.AnalysisConfig(str(tmp_path / "mlp")).enable_int8(
            calibration_feeds=feeds))
    assert [op.type for op in p_q.program.global_block().ops] == \
        [op.type for op in jq.program.global_block().ops]
    assert (jq.int8_weight_tensors, jq.int8_calibrated_activations) == \
        (p_q.int8_weight_tensors, p_q.int8_calibrated_activations)
    np.testing.assert_allclose(got, np.asarray(jq.run(feeds[0])[0]),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# generation_server: tests/api/test_serving_engine.py:380,406 and
# tests/api/test_quant_serving.py:440
# ---------------------------------------------------------------------------

def _port_cfg(cfg):
    return tgpt.GPTConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        inner_size=cfg.inner_size, max_position=cfg.max_position,
        dropout=0.0)


@pytest.fixture(scope="module")
def tiny_gpt(tmp_path_factory):
    """test_serving_engine.py's tiny_gpt (startup seed 11), exported by
    JAX's save_inference_model: (JAX cfg, JAX params, model dir)."""
    cfg = jgpt.gpt_tiny()
    main, startup = jframework.Program(), jframework.Program()
    main.random_seed = startup.random_seed = 11
    with jframework.program_guard(main, startup):
        _tokens, _loss, logits = jgpt.build_lm_net(cfg, seq_len=8)
    scope = jfluid.Scope()
    exe = jfluid.Executor()
    path = str(tmp_path_factory.mktemp("gpt") / "gpt")
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(path, ["tokens"], [logits], exe,
                                       main_program=main)
    return cfg, jgpt.load_params(scope, cfg), path


def _jax_reference_greedy(params, cfg, prompt, n_new, max_len=64):
    """test_serving_engine.py's _reference_greedy: the JAX dense-cache
    per-token loop, teacher-forcing the prompt, then greedy."""
    d = cfg.hidden_size // cfg.num_heads
    step = jgpt.build_kv_step(params, cfg, max_len)
    cache = jdec.init_kv_cache(1, cfg.num_layers, cfg.num_heads, max_len, d)
    logits = None
    for t, tok in enumerate(prompt):
        logits, cache = step(jnp.asarray([tok], jnp.int32), cache, t)
    out = []
    t = len(prompt)
    cur = int(np.argmax(np.asarray(logits)[0]))
    out.append(cur)
    for _ in range(n_new - 1):
        logits, cache = step(jnp.asarray([cur], jnp.int32), cache, t)
        cur = int(np.argmax(np.asarray(logits)[0]))
        out.append(cur)
        t += 1
    return out


GEN_OPTS = dict(num_slots=2, block_size=8, max_context=64, chunk=4)


def _serve(srv, prompt, n):
    fut = srv.submit(prompt, max_new_tokens=n)
    srv.run_until_idle()
    ids = list(fut.result(timeout=5).token_ids)
    st = srv.get_stats()
    srv.close()
    return ids, st


def test_predictor_enable_generation_entry_point(tiny_gpt):
    """AnalysisConfig.enable_generation -> Predictor.generation_server
    from JAX's saved model dir reproduces the JAX reference decode's ids
    and a port server built directly from the same parameters."""
    cfg, params, path = tiny_gpt
    tcfg = _port_cfg(cfg)
    pred = tinference.create_predictor(
        _port(path).enable_generation(tcfg, **GEN_OPTS))
    prompt = np.array([5, 9, 11], np.int32)
    ids, st = _serve(pred.generation_server(start=False), prompt, 6)
    assert ids == _jax_reference_greedy(params, cfg, prompt, 6)
    assert st["fused_step_signatures"] == 1
    assert st["device"] == "cpu" and st["kernel"] == {
        "launches": st["kernel"]["launches"], "engaged": False}
    direct = GenerationServer(
        GPTServingModel(tgpt.load_params(pred.scope, tcfg), tcfg,
                        device="cpu"), device="cpu", start=False,
        **GEN_OPTS)
    assert _serve(direct, prompt, 6)[0] == ids


def test_generation_not_enabled_raises(tiny_gpt):
    _cfg, _params, path = tiny_gpt
    pred = tinference.create_predictor(_port(path))
    with pytest.raises(RuntimeError, match="enable_generation"):
        pred.generation_server()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """test_quant_serving.py's briefly-trained tiny GPT (30 Adam steps on
    four sequences), exported by JAX: (JAX cfg, model dir)."""
    cfg = jgpt.gpt_tiny()
    main, startup = jframework.Program(), jframework.Program()
    main.random_seed = startup.random_seed = 5
    with jframework.program_guard(main, startup):
        _tokens, loss, _ = jgpt.build_lm_net(cfg, seq_len=16)
        jfluid.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    infer_main, infer_startup = jframework.Program(), jframework.Program()
    with jframework.program_guard(infer_main, infer_startup):
        _t, _l, logits = jgpt.build_lm_net(cfg, seq_len=8)
    scope = jfluid.Scope()
    exe = jfluid.Executor()
    seq = np.random.default_rng(0).integers(
        3, cfg.vocab_size, (4, 16)).astype(np.int32)
    path = str(tmp_path_factory.mktemp("gpt8") / "gpt")
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(30):
            exe.run(main, feed={"tokens": seq}, fetch_list=[loss])
        jfluid.io.save_inference_model(path, ["tokens"], [logits], exe,
                                       main_program=infer_main)
    return cfg, path


def test_enable_int8_generation_end_to_end(trained):
    """enable_int8 + enable_generation: the served engine runs int8
    weights AND int8 KV, gives the ids of a direct port server over
    quantize_int8() with kv_dtype="int8" bitwise, matches the dense
    predictor server's ids at the accuracy floor, and keeps one fused
    step signature."""
    cfg, path = trained
    tcfg = _port_cfg(cfg)
    prompt = [5, 9, 11]
    dense = tinference.create_predictor(
        _port(path).enable_generation(tcfg, **GEN_OPTS))
    dense_ids, _ = _serve(dense.generation_server(start=False), prompt, 8)
    quant = tinference.create_predictor(
        _port(path).enable_int8().enable_generation(tcfg, **GEN_OPTS))
    q_ids, qst = _serve(quant.generation_server(start=False), prompt, 8)
    rate = sum(a == b for a, b in zip(dense_ids, q_ids)) / len(dense_ids)
    assert rate >= 0.9, f"enable_int8 generation exact-match {rate}"
    assert qst["kv_quant"]["kv_dtype"] == "int8"
    assert qst["kv_quant"]["int8_weights"] == 6 * cfg.num_layers
    assert qst["fused_step_signatures"] == 1
    model = GPTServingModel(tgpt.load_params(dense.scope, tcfg), tcfg,
                            device="cpu").quantize_int8()
    direct = GenerationServer(model, device="cpu", start=False,
                              kv_dtype="int8", **GEN_OPTS)
    assert _serve(direct, prompt, 8)[0] == q_ids
