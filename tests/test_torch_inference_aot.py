"""The port's AOT serving artifacts (``paddle_tpu_torch.inference.aot``:
``torch.export`` of the Executor's inference walk) against the JAX
package, on the CPU.

Twins of the four tests of ``tests/io/test_aot_model.py`` that are not
dygraph (``test_traced_layer_save_inference_model`` waits for item 11d):
the JAX package builds and initialises the net and writes its inference
model; the port loads those files into a scope of its own, exports, and
the loaded artifact must give the JAX training-time forward's outputs
(rtol 1e-5, the JAX test's). Two more:

- a CPU artifact loaded and run in a subprocess that imports only
  ``torch`` and ``numpy``: the artifact stands alone;
- the graph of an export whose flash forward is the registered op
  ``paddle_tpu_torch::flash_attention_fwd`` (as on the card): every call
  is an aten op but that op, one node a layer (and ``operator.getitem``,
  which unpacks its (out, lse)).

``save_train_step`` / ``load_train_step`` / ``TrainStepArtifact``
(``aot.py:169-286`` of the JAX package) are left for ROADMAP item 11b.2:
``AOT_NAMES_LEFT``.
"""

import json
import operator
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu import layers as jlayers
from paddle_tpu.core import framework as jframework
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.inference import aot as taot

# names of the JAX aot module the port's does not have, with the ROADMAP
# item each waits for
AOT_NAMES_LEFT = {
    "save_train_step": "A, item 11b.2 (the train-step export)",
    "load_train_step": "A, item 11b.2 (the train-step export)",
    "TrainStepArtifact": "A, item 11b.2 (the train-step export)",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _net(fluid, layers, framework, static_batch=None):
    main, startup = framework.Program(), framework.Program()
    with fluid.unique_name.guard(), framework.program_guard(main, startup):
        if static_batch is None:
            x = fluid.data(name="x", shape=[-1, 8], dtype="float32")
            h = layers.fc(x, size=16, act="relu")
            pred = layers.fc(h, size=3, act="softmax")
        else:
            x = fluid.data(name="x", shape=[static_batch, 8],
                           dtype="float32")
            pred = layers.fc(x, size=2)
    return main, startup, pred


def _jax_export(tmp_path, feeds=(), static_batch=None):
    """JAX initialises the net and writes its inference model; returns
    (model dir, JAX forward of each feed)."""
    main, startup, pred = _net(jfluid, jlayers, jframework, static_batch)
    exe = jfluid.Executor()
    path = str(tmp_path / "m")
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        infer = main.clone(for_test=True)
        wants = [np.asarray(exe.run(infer, feed={"x": x},
                                    fetch_list=[pred])[0]) for x in feeds]
        jfluid.io.save_inference_model(path, ["x"], [pred], exe,
                                       main_program=main)
    return path, wants


def _port_load(model_dir):
    """The export loaded by the port onto the CPU: (program, feed names,
    fetch names, scope)."""
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        program, feed_names, fetch_vars = tfluid.io.load_inference_model(
            model_dir, exe)
    return program, feed_names, [v.name for v in fetch_vars], scope


def test_aot_names_left_are_named():
    """Every public name of the JAX aot module is the port's, but those
    AOT_NAMES_LEFT lists (the train-step export, item 11b.2)."""
    from paddle_tpu.inference import aot as jaot
    public = {n for n in dir(jaot) if not n.startswith("_")
              and callable(getattr(jaot, n))
              and getattr(getattr(jaot, n), "__module__", "") == jaot.__name__}
    missing = {n for n in public if not hasattr(taot, n)}
    assert missing == set(AOT_NAMES_LEFT), missing


def test_aot_roundtrip_matches_live_program(tmp_path):
    rs = np.random.RandomState(0)
    x1 = rs.rand(1, 8).astype(np.float32)
    x8 = rs.rand(8, 8).astype(np.float32)
    model_dir, (want1, want8) = _jax_export(tmp_path, (x1, x8))
    program, feeds, fetches, scope = _port_load(model_dir)
    files = tinference.save_aot_model(
        str(tmp_path / "aot"), program, feeds, fetches,
        example_batches=(1, 8), scope=scope)
    assert files == ["sig_b1.pt2", "sig_b8.pt2"]
    with open(tmp_path / "aot" / "aot_meta.json") as f:
        meta = json.load(f)
    assert meta["device"] == "cpu" and meta["feed_names"] == ["x"]
    assert [s["shapes"] for s in meta["signatures"]] == [
        {"x": [1, 8]}, {"x": [8, 8]}]
    # load with NO scope/program anywhere in sight: the artifact is
    # self-contained (the persistables are its buffers)
    del program, scope
    model = tinference.load_aot_model(str(tmp_path / "aot"))
    assert model.batch_sizes() == [1, 8]
    np.testing.assert_allclose(model.run({"x": x1})[0], want1, rtol=1e-5)
    np.testing.assert_allclose(model({"x": x8})[0], want8, rtol=1e-5)


def test_aot_unknown_batch_raises(tmp_path):
    model_dir, _ = _jax_export(tmp_path)
    program, feeds, fetches, scope = _port_load(model_dir)
    tinference.save_aot_model(str(tmp_path / "aot"), program, feeds,
                              fetches, example_batches=(4,), scope=scope)
    model = tinference.load_aot_model(str(tmp_path / "aot"))
    with pytest.raises(ValueError, match="no compiled signature"):
        model.run({"x": np.zeros((5, 8), np.float32)})


def test_aot_static_batch_feed(tmp_path):
    """fluid.data with a static leading batch: the declared batch is THE
    signature; other buckets raise instead of exporting wrong-rank."""
    model_dir, _ = _jax_export(tmp_path, static_batch=4)
    program, feeds, fetches, scope = _port_load(model_dir)
    with pytest.raises(ValueError, match="static batch"):
        tinference.save_aot_model(str(tmp_path / "aot"), program, feeds,
                                  fetches, example_batches=(8,),
                                  scope=scope)
    tinference.save_aot_model(str(tmp_path / "aot"), program, feeds,
                              fetches, example_batches=(4,), scope=scope)
    model = tinference.load_aot_model(str(tmp_path / "aot"))
    out = model.run({"x": np.ones((4, 8), np.float32)})
    assert out[0].shape == (4, 2)


def test_aot_missing_param_raises(tmp_path):
    main, _startup, pred = _net(tfluid, tlayers, tframework)
    scope = tfluid.Scope()                    # startup never ran
    with pytest.raises(ValueError, match="no value in scope"):
        tinference.save_aot_model(str(tmp_path), main.clone(for_test=True),
                                  ["x"], [pred], scope=scope)


def test_save_aot_callable_roundtrip(tmp_path):
    """save_aot_callable exports an arbitrary fn({name: tensor}) ->
    [outputs] at the example feeds' one signature."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    files = taot.save_aot_callable(
        str(tmp_path), lambda f: [f["x"] * 2.0 + 1.0, f["x"].sum(1)],
        {"x": x}, fetch_names=("y", "s"))
    assert files == ["sig_b3.pt2"]
    model = tinference.load_aot_model(str(tmp_path))
    assert model.batch_sizes() == [3] and model.fetch_names == ["y", "s"]
    y, s = model.run({"x": x})
    np.testing.assert_array_equal(y, x * 2 + 1)
    np.testing.assert_array_equal(s, x.sum(1))


def test_aot_feed_spec_raises():
    """_feed_specs' three raises, as JAX's: no declared shape, a static
    batch other than the requested, a dynamic non-batch dim."""
    main = tframework.Program()
    with tframework.program_guard(main, tframework.Program()):
        tfluid.data(name="s", shape=[], dtype="float32")
        tfluid.data(name="b", shape=[4, 8], dtype="float32")
        tfluid.data(name="d", shape=[-1, -1], dtype="float32")
    for name, msg in (("s", "no declared shape"), ("b", "static batch"),
                      ("d", "dynamic non-batch dim")):
        with pytest.raises(ValueError, match=msg):
            taot._feed_specs(main, [name], 2)


_STANDALONE = r"""
import sys
import numpy as np
import torch
mod = torch.export.load(sys.argv[1]).module()
x = np.load(sys.argv[2])
out = mod(torch.from_numpy(x))
np.save(sys.argv[3], out[0].detach().numpy())
bad = [k for k in sys.modules if k.split(".")[0] in
       ("jax", "jaxlib", "paddle_tpu", "paddle_tpu_torch")]
assert not bad, bad
"""


def test_aot_cpu_artifact_stands_alone(tmp_path):
    """A CPU artifact runs in a process that imports only torch and
    numpy: no Program, no op registry, no scope, no package."""
    x = np.random.RandomState(2).rand(8, 8).astype(np.float32)
    model_dir, (want,) = _jax_export(tmp_path, (x,))
    program, feeds, fetches, scope = _port_load(model_dir)
    tinference.save_aot_model(str(tmp_path / "aot"), program, feeds,
                              fetches, example_batches=(8,), scope=scope)
    np.save(tmp_path / "x.npy", x)
    res = subprocess.run(
        [sys.executable, "-c", _STANDALONE,
         str(tmp_path / "aot" / "sig_b8.pt2"), str(tmp_path / "x.npy"),
         str(tmp_path / "out.npy")],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode == 0, res.stderr
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), want,
                               rtol=1e-5)


def _targets(ep):
    return [n.target for n in ep.graph.nodes if n.op == "call_function"]


def test_aot_cpu_graph_calls_aten_only(tmp_path):
    """On the CPU the walk takes the plain versions: the exported graph
    calls aten ops and nothing else."""
    model_dir, _ = _jax_export(tmp_path)
    program, feeds, fetches, scope = _port_load(model_dir)
    tinference.save_aot_model(str(tmp_path / "aot"), program, feeds,
                              fetches, example_batches=(2,), scope=scope)
    ep = torch.export.load(str(tmp_path / "aot" / "sig_b2.pt2"))
    targets = _targets(ep)
    assert targets and all(
        isinstance(t, torch._ops.OpOverload) and t.namespace == "aten"
        for t in targets), targets


def test_aot_walk_exports_the_flash_op_as_one_node(monkeypatch):
    """The export of the BERT classifier's inference walk with the flash
    forward as the registered op: one flash_attention_fwd node a layer,
    every other call an aten op or the getitem that unpacks the op's
    (out, lse). A CPU-only torch cannot trace CUDA tensors (indexing a
    fake CUDA tensor asks for the CUDA runtime), so the walk runs on meta
    tensors here and the CPU's plain attention is routed through the op
    (its fake implementation gives the shapes); on the card
    ``flash_attention_cuda`` makes that call (chip_smoke.py phase 37c)."""
    from paddle_tpu_torch.models import bert as tbert
    from paddle_tpu_torch.ops import attention_ops
    flash = torch.ops.paddle_tpu_torch.flash_attention_fwd.default

    def through_op(q, k, v, bias=None, scale=None, causal=False):
        scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
        if bias is not None:
            bias = bias.float().expand(q.shape[0], q.shape[1], q.shape[2],
                                       k.shape[2])
        return torch.ops.paddle_tpu_torch.flash_attention_fwd(
            q, k, v, bias, None, None, scale, bool(causal))[0]

    monkeypatch.setattr(attention_ops, "_xla_attention", through_op)
    cfg = tbert.bert_tiny()
    main, startup = tframework.Program(), tframework.Program()
    with tfluid.unique_name.guard(), \
            tframework.program_guard(main, startup):
        _f, _loss, _acc, probs = tbert.build_classifier_net(
            cfg, seq_len=32, num_labels=3)
    infer = main.clone(for_test=True)
    feed_names = ["input_mask", "sent_ids", "src_ids"]
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    meta = torch.device("meta")
    state = {v.name: scope.get(v.name).to(meta)
             for v in infer.list_vars() if v.persistable}
    module = taot._InferenceModule(infer, feed_names, [probs.name], state,
                                   meta)
    specs = taot._feed_specs(infer, feed_names, 2)
    example = tuple(torch.zeros(s, dtype=d, device=meta)
                    for s, d in (specs[k] for k in feed_names))
    with torch.no_grad():
        ep = torch.export.export(module, example, strict=False)
    targets = _targets(ep)
    assert targets.count(flash) == cfg.num_hidden_layers
    others = [t for t in targets if t is not flash]
    assert all(t is operator.getitem or (
        isinstance(t, torch._ops.OpOverload) and t.namespace == "aten")
        for t in others), {str(t) for t in others}
