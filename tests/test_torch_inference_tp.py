"""Tensor-parallel serving through the port's Predictor
(``AnalysisConfig.enable_tensor_parallel``) against the JAX package, on
the CPU: twins of the four tests of ``tests/parallel/test_tp_predictor.py``
and of ``tests/io/test_batching_server.py``'s tp test.

The JAX package exports the tiny BERT classifier (the shared
``bert_classifier_export`` fixture of ``tests/conftest.py``: its
dropout-off single-device forward is the reference); the port's Predictor
loads that directory onto a local tp 2 mesh of two CPU positions. Where
the JAX test reads the compiled HLO for its all-reduces, the port's walk
counts the mesh's ``reductions`` (the row-parallel products' partial
sums); where it reads the jax Arrays' NamedSharding, the port's scope
holds ``ShardedTensor``s split over tp. Tolerances are the JAX tests'
own: rtol 2e-5, atol 2e-6 in f32, 3e-2 in bf16 against the f32
reference, and ``BF16_ATOL`` between the two packages' bf16 tp
Predictors.
"""

import warnings

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu.core import framework as jframework
from paddle_tpu.models import bert as jbert
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.parallel import ShardedTensor, make_mesh

RTOL, ATOL = 2e-5, 2e-6
# the two packages' bf16 tp Predictors: bf16 activations rounded at other
# points (measured 7.8e-3 at tp 2, 3.9e-3 on one device)
BF16_ATOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _mesh():
    return make_mesh(tp=2, devices=["cpu", "cpu"])


def _tp_config(model_dir, mesh):
    return tinference.AnalysisConfig(model_dir).disable_gpu() \
        .enable_tensor_parallel(mesh)


def _tp_sharded(scope):
    return sum(1 for n in scope.names()
               if isinstance(scope.get(n), ShardedTensor)
               and "tp" in tuple(scope.get(n).spec))


def test_tp_predictor_matches_single_device(bert_classifier_export):
    model_dir, feed, ref_out = bert_classifier_export
    predictor = tinference.create_predictor(_tp_config(model_dir, _mesh()))
    out = predictor.run(feed)
    np.testing.assert_allclose(out[0], ref_out, rtol=RTOL, atol=ATOL)
    # serve twice: state stays sharded, results stable
    out2 = predictor.run(feed)
    np.testing.assert_array_equal(out2[0], out[0])
    single = tinference.create_predictor(
        tinference.AnalysisConfig(model_dir).disable_gpu()).run(feed)
    np.testing.assert_allclose(out[0], single[0], rtol=RTOL, atol=ATOL)


def test_tp_predictor_state_is_sharded_and_step_communicates(
        bert_classifier_export):
    model_dir, feed, _ref_out = bert_classifier_export
    mesh = _mesh()
    predictor = tinference.create_predictor(_tp_config(model_dir, mesh))
    before = mesh.reductions
    predictor.run(feed)
    # column-parallel ffn / attention weights live sharded over tp in the
    # serving scope (half the weight a rank)
    sharded = _tp_sharded(predictor.scope)
    assert sharded >= 4, f"only {sharded} tp-sharded params in scope"
    # and the walk's row-parallel products reduce over tp every run
    # (attention out and ffn down, a layer)
    once = mesh.reductions - before
    assert once >= 2 * 2, once
    predictor.run(feed)
    assert mesh.reductions - before == 2 * once


def test_tp_predictor_serves_fluid_protobuf_export(tmp_path):
    """The reference-__model__ branch: weights rebuilt as plain Variables
    (no Parameter objects) must STILL shard (test_tp_predictor.py's r5
    finding)."""
    cfg = jbert.bert_tiny()
    main, startup = jframework.Program(), jframework.Program()
    with jframework.program_guard(main, startup):
        _feeds, _loss, _acc, probs = jbert.build_classifier_net(
            cfg, seq_len=32, num_labels=3)
    exe = jfluid.Executor()
    full = jbert.make_pretrain_feed(cfg, 32, 4)
    infer_names = ["input_mask", "sent_ids", "src_ids"]
    infer_feed = {k: full[k] for k in infer_names}
    test_prog = main.clone(for_test=True)
    from paddle_tpu.io.fluid_proto import save_fluid_inference_model
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        save_fluid_inference_model(
            str(tmp_path / "ref"), infer_names, [probs], exe,
            main_program=main)
        ref_out = np.asarray(exe.run(
            test_prog, feed=dict(infer_feed,
                                 label=np.zeros((4, 1), np.int64)),
            fetch_list=[probs])[0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no 'serving REPLICATED'
        predictor = tinference.create_predictor(
            _tp_config(str(tmp_path / "ref"), _mesh()))
    out = predictor.run(infer_feed)
    np.testing.assert_allclose(out[0], ref_out, rtol=RTOL, atol=ATOL)
    # the protobuf-loaded weights are sharded in scope
    sharded = _tp_sharded(predictor.scope)
    assert sharded >= 4, f"only {sharded} tp-sharded vars (protobuf path)"


def test_tp_predictor_composes_with_bf16(bert_classifier_export):
    model_dir, feed, ref_out = bert_classifier_export
    predictor = tinference.create_predictor(
        _tp_config(model_dir, _mesh()).enable_bf16())
    out = predictor.run(feed)
    # bf16 params: looser tolerance, same answer
    np.testing.assert_allclose(out[0], ref_out, rtol=3e-2, atol=3e-2)
    jmesh = jmake_mesh(tp=2, devices=jax.devices()[:2])
    jcfg = (jinference.AnalysisConfig(model_dir)
            .enable_bf16().enable_tensor_parallel(jmesh))
    jout = np.asarray(jinference.create_predictor(jcfg).run(feed)[0],
                      np.float32)
    np.testing.assert_allclose(out[0], jout, rtol=0, atol=BF16_ATOL)


def test_batching_server_over_tp_predictor(bert_classifier_export):
    """test_batching_server.py's tp test with the port's stack: the
    native micro-batching queue -> bucket-padded Predictor -> the tp
    walk on a tp 2 mesh. Every concurrent client gets its own rows,
    equal to the single-device forward."""
    model_dir, infer_feed, ref = bert_classifier_export
    cfg = _tp_config(model_dir, _mesh()).set_batch_buckets([4, 8])
    predictor = tinference.create_predictor(cfg)
    srv = serving.BatchingServer(predictor, max_batch=8,
                                 max_delay_ms=20.0)
    try:
        n = next(iter(infer_feed.values())).shape[0]
        futs = [srv.submit({k: v[i:i + 1] for k, v in infer_feed.items()})
                for i in range(n)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(120)[0], ref[i:i + 1],
                                       rtol=RTOL, atol=ATOL)
    finally:
        srv.close()
