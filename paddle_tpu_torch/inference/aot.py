"""AOT serving artifacts: export a Program once, save it, serve it anywhere.

Parity: the reference's inference engine ahead-of-time story (an
optimized, self-contained artifact the serving fleet loads without the
training stack); the port of ``paddle_tpu/inference/aot.py``. Where JAX
serializes the traced StableHLO with ``jax.export``, the port exports
the Executor's inference walk with ``torch.export``:

- an ``nn.Module`` holds the program's persistables as buffers (they are
  constants of the artifact, as JAX bakes its params in) and its
  ``forward`` is ``core.executor.inference_walk``: the ops ``_slice_ops``
  keeps for the fetches, each through ``run_op`` in test mode, the
  random ops seeded (0, 0) as JAX's ``PRNGKey(0)``;
- ``torch.export.export(..., strict=False)`` traces it once per batch
  size; each ``sig_b{batch}.pt2`` holds an aten graph (on the card the
  flash forward is one node, the registered op
  ``paddle_tpu_torch::flash_attention_fwd``), saved with
  ``torch.export.save``; ``aot_meta.json`` names the feeds, the fetches
  and the signatures.

    save_aot_model(path, program, feed_names, fetch_names,
                   example_batches=[1, 8], scope=scope)
    model = load_aot_model(path)
    out = model.run({"x": x})          # picks the matching signature

``load_aot_model`` rebuilds no Program and reads no scope: it loads each
signature with ``torch.export.load(...).module()``. A CPU artifact needs
nothing but torch to run; one exported on the card holds the flash op,
which the loading process registers by importing
``paddle_tpu_torch.ops.cuda.flash`` (``load_aot_model`` does).

Not ported here: the train-step export (``save_train_step``,
``load_train_step``, ``TrainStepArtifact``), which needs the whole step,
``torch.autograd.grad`` included, in one exported graph (ROADMAP item
11b.2).
"""

import json
import os

import numpy as np
import torch

from ..core.executor import global_scope, host_array, inference_walk

_ARTIFACT_SUFFIX = ".pt2"


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


class _InferenceModule(torch.nn.Module):
    """forward(*feeds in feed_names order) -> [fetches]: the inference
    walk of `program` over buffers holding `state` (Fluid names carry
    dots, which buffer names cannot, so buffer i holds the i-th name of
    the sorted state)."""

    def __init__(self, program, feed_names, fetch_names, state, device):
        super().__init__()
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        self._state_names = sorted(state)
        self._device = device
        for i, name in enumerate(self._state_names):
            self.register_buffer(f"p{i}", state[name])

    def forward(self, *feeds):
        env = {n: getattr(self, f"p{i}")
               for i, n in enumerate(self._state_names)}
        env.update(zip(self._feed_names, feeds))
        return inference_walk(self._program, env, self._fetch_names,
                              self._device, is_test=True, rng=(0, 0))


class _CallableModule(torch.nn.Module):
    """forward(*feeds) -> fn({name: feed}), for save_aot_callable."""

    def __init__(self, fn, feed_names):
        super().__init__()
        self._fn = fn
        self._feed_names = list(feed_names)

    def forward(self, *feeds):
        return list(self._fn(dict(zip(self._feed_names, feeds))))


def _feed_specs(program, feed_names, batch):
    """{name: (shape, torch dtype)} of the feeds at `batch`; raises where
    the declared shapes cannot take it."""
    from ..ops import torch_dtype
    specs = {}
    gb = program.global_block()
    for name in feed_names:
        v = gb.var(name)
        dims = [int(d) for d in v.shape]
        if not dims:
            raise ValueError(f"feed '{name}' has no declared shape")
        if dims[0] == -1:
            dims[0] = batch
        elif dims[0] != batch:
            # fluid.data with a STATIC leading batch: the var shape
            # already includes it; a different requested bucket can't
            # exist
            raise ValueError(
                f"feed '{name}' declares a static batch {dims[0]}; "
                f"example_batches must be ({dims[0]},), got {batch}")
        if any(d < 0 for d in dims[1:]):
            raise ValueError(
                f"feed '{name}' has a dynamic non-batch dim {dims}; AOT "
                "export is shape-specialized — declare static shapes")
        specs[name] = (tuple(dims), torch_dtype(v.dtype))
    return specs


def save_aot_model(dirname, program, feed_names, fetch_names,
                   example_batches=(1,), scope=None):
    """Export one artifact per batch size. The program should be an
    inference graph (``clone(for_test=True)`` / load_inference_model's);
    the persistables come from `scope` (default global) and stay on their
    device: an artifact exported from the card's tensors runs on the
    card. Returns the artifact file names."""
    scope = scope or global_scope()
    fetch_names = [v.name if hasattr(v, "name") else v for v in fetch_names]
    state = {}
    gb = program.global_block()
    for v in gb.vars.values():
        if v.persistable and v.name not in ("feed", "fetch"):
            val = scope.get(v.name)
            if val is None:
                raise ValueError(f"param '{v.name}' has no value in scope")
            state[v.name] = val
    device = (next(iter(state.values())).device if state
              else torch.device("cpu"))
    module = _InferenceModule(program, feed_names, fetch_names, state,
                              device)
    specs_by_batch = {int(b): _feed_specs(program, feed_names, b)
                      for b in example_batches}
    return _write_artifacts(dirname, module, specs_by_batch, feed_names,
                            fetch_names, device)


def _write_artifacts(dirname, module, specs_by_batch, feed_names,
                     fetch_names, device):
    """Export `module` once per signature, save each, and write the
    shared aot_meta.json (the ONE place that knows the artifact layout
    load_aot_model reads)."""
    os.makedirs(dirname, exist_ok=True)
    sigs = []
    for batch, specs in specs_by_batch.items():
        example = tuple(torch.zeros(shape, dtype=dt, device=device)
                        for shape, dt in (specs[k] for k in feed_names))
        with torch.no_grad():
            ep = torch.export.export(module, example, strict=False)
        fname = f"sig_b{batch}{_ARTIFACT_SUFFIX}"
        torch.export.save(ep, os.path.join(dirname, fname))
        sigs.append({"batch": batch, "file": fname,
                     "shapes": {k: list(s) for k, (s, _) in specs.items()},
                     "dtypes": {k: _dtype_name(d)
                                for k, (_, d) in specs.items()}})
    meta = {"feed_names": list(feed_names),
            "fetch_names": list(fetch_names), "device": device.type,
            "signatures": sigs}
    with open(os.path.join(dirname, "aot_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return [s["file"] for s in sigs]


def save_aot_callable(dirname, fn, example_feeds, fetch_names=("out",)):
    """Export an arbitrary fn({name: tensor}) -> [outputs] as an AOT
    artifact (one signature: the example feeds' shapes, on their
    device)."""
    feeds = {k: v if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v, copy=True))
             for k, v in example_feeds.items()}
    first = next(iter(feeds.values()))
    batch = int(first.shape[0]) if first.dim() else 1
    specs = {k: (tuple(v.shape), v.dtype) for k, v in feeds.items()}
    return _write_artifacts(dirname, _CallableModule(fn, list(feeds)),
                            {batch: specs}, list(feeds), list(fetch_names),
                            first.device)


class AotModel:
    """Serving handle over the loaded signatures; run() dispatches on the
    feed batch size (exact match required: the artifact is
    shape-specialized by design)."""

    def __init__(self, meta, exported):
        self.feed_names = meta["feed_names"]
        self.fetch_names = meta["fetch_names"]
        self.device = torch.device(meta.get("device", "cpu"))
        self._dtypes = {s["batch"]: s["dtypes"] for s in meta["signatures"]}
        # batch -> torch.export.ExportedProgram, and its callable module
        self.exported = exported
        self._by_batch = {b: ep.module() for b, ep in exported.items()}

    def batch_sizes(self):
        return sorted(self._by_batch)

    def run(self, feeds):
        first = feeds[self.feed_names[0]]
        batch = int(np.asarray(first).shape[0])
        mod = self._by_batch.get(batch)
        if mod is None:
            raise ValueError(
                f"no compiled signature for batch {batch}; available: "
                f"{self.batch_sizes()} (export more via example_batches)")
        dtypes = self._dtypes[batch]
        args = [torch.as_tensor(np.asarray(feeds[k])).to(
            self.device, getattr(torch, dtypes[k]))
            for k in self.feed_names]
        with torch.no_grad():
            outs = mod(*args)
        return [host_array(o) for o in outs]

    __call__ = run


def load_aot_model(dirname):
    # an artifact exported on the card holds the flash forward as the
    # registered op paddle_tpu_torch::flash_attention_fwd
    from ..ops.cuda import flash  # noqa: F401
    with open(os.path.join(dirname, "aot_meta.json")) as f:
        meta = json.load(f)
    exported = {sig["batch"]: torch.export.load(
        os.path.join(dirname, sig["file"])) for sig in meta["signatures"]}
    return AotModel(meta, exported)
