"""Predictor: a saved inference model behind Fluid's inference entry point.

Parity: paddle/fluid/inference/api/analysis_predictor.cc; the port of
``paddle_tpu/inference/predictor.py``. ``create_predictor(config)`` loads
a model that ``save_inference_model`` wrote (the JAX package's layout or
the port's, the same files) or a reference ``__model__`` directory, into
a Scope of its own on the card, and serves it through the Executor's
inference walk: one eager walk of the pruned Program a call, the
attention through the flash kernels on the card. The JAX Predictor's
compiled signatures are the port's bucket sizes: ``predict_batch`` pads a
request to the nearest bucket (and splits one past the largest), so a
batching front end sees only those shapes.

``AnalysisConfig``:

- ``disable_gpu()``: serve on the CPU. Fluid 1.5's own call, and the
  port's only device switch: without it the Predictor runs on the card
  and raises when CUDA is unavailable;
- ``enable_bf16()``: every float tensor of the loaded scope becomes
  bf16; float feeds stay f32, and the ops promote mixed operands as
  ``jnp`` does (ROADMAP C23);
- ``enable_int8(calibration_feeds)``: ``quant.ptq.apply_ptq`` with
  per-output-channel weights, after calibrating static activation scales
  on the feeds when given; in generation, int8 weights and an int8 KV
  pool;
- ``set_batch_buckets(sizes)``, ``enable_generation(gpt_config,
  **server_opts)`` (``Predictor.generation_server``) and
  ``enable_tensor_parallel(mesh, rules)``: every persistable variable is
  annotated by the shard rules and the Program runs through
  ``CompiledProgram(program).with_mesh(mesh)``, the tensor-parallel walk.
"""

import os
import warnings

import numpy as np
import torch

from ..core.executor import Executor, Scope, scope_guard
from ..core.place import CPUPlace, CUDAPlace
from ..io.inference_io import load_inference_model


class AnalysisConfig:
    """Parity: AnalysisConfig, the knobs that matter to the port."""

    def __init__(self, model_dir=None):
        self.model_dir = model_dir
        self.use_bf16 = False
        self.fixed_batch_sizes = ()   # pad-to-bucket batch sizes
        self.mesh = None              # tensor-parallel serving mesh
        self.shard_rules = None
        self.generation = None        # enable_generation() options
        self.use_int8 = False
        self.int8_calibration_feeds = None
        self._use_gpu = True

    def disable_gpu(self):
        """Serve on the CPU (Fluid 1.5's AnalysisConfig.disable_gpu)."""
        self._use_gpu = False
        return self

    def use_gpu(self):
        return self._use_gpu

    def enable_bf16(self):
        self.use_bf16 = True
        return self

    def enable_int8(self, calibration_feeds=None):
        """Quantized serving: every quantizable mul / matmul / conv
        weight of the loaded program gets per-output-channel absmax int8
        quant-dequant (``quant.ptq.apply_ptq(...,
        weight_granularity="channel")``); `calibration_feeds` (an
        iterable of feed dicts) also calibrates static activation scales
        (``quant.ptq.calibrate_program``). In generation
        (``generation_server``) the model's matmul weights become int8
        (``GPTServingModel.quantize_int8``) and the KV pool defaults to
        ``kv_dtype="int8"``."""
        self.use_int8 = True
        self.int8_calibration_feeds = calibration_feeds
        return self

    def enable_generation(self, gpt_config, **server_opts):
        """Serve this model as a continuous-batching generation engine
        (``serving.GenerationServer`` over a paged KV cache): `gpt_config`
        names the decoder the exported gpt_* parameters follow
        (``models/gpt.GPTConfig``), `server_opts` pass through to
        GenerationServer (num_slots, block_size, max_context, chunk, ...).
        ``Predictor.generation_server()`` builds the server."""
        self.generation = dict(server_opts)
        self.generation["gpt_config"] = gpt_config
        return self

    def set_batch_buckets(self, sizes):
        self.fixed_batch_sizes = tuple(sorted(sizes))
        return self

    def enable_tensor_parallel(self, mesh, rules=None):
        """Serve the model sharded over `mesh`'s tp axis: persistables
        get dist_attr annotations (``parallel.ShardRules``; pass `rules`
        to customize) and the forward runs as the CompiledProgram's
        tensor-parallel walk, the mesh reducing the row-parallel
        products' partials."""
        self.mesh = mesh
        self.shard_rules = rules
        return self


class Predictor:
    def __init__(self, config):
        self.config = config
        self.scope = Scope()
        self._exe = Executor(CUDAPlace(0) if config.use_gpu()
                             else CPUPlace())
        with scope_guard(self.scope):
            if os.path.exists(os.path.join(config.model_dir, "__model__")):
                # a REFERENCE export dir (save_inference_model's
                # ProgramDesc protobuf + weights): served directly
                from ..io.fluid_proto import load_fluid_inference_model
                (self.program, self.feed_names,
                 self.fetch_names) = load_fluid_inference_model(
                    config.model_dir, self._exe)
            else:
                (self.program, self.feed_names,
                 fetch_vars) = load_inference_model(config.model_dir,
                                                    self._exe)
                self.fetch_names = [v.name for v in fetch_vars]
        if config.use_bf16:
            self._cast_params_bf16()
        if config.use_int8:
            self._apply_int8()
        # tensor-parallel serving: annotate every persistable VAR (not
        # only Parameter objects: the reference-__model__ branch above
        # rebuilds weights as plain Variables, which
        # program.all_parameters() misses, and would serve replicated)
        self._run_prog = self.program
        if config.mesh is not None:
            from ..core.compiler import CompiledProgram
            from ..parallel.tensor_parallel import ShardRules
            rules = config.shard_rules or ShardRules()
            annotated = 0
            for v in self.program.list_vars():
                if v.persistable and v.name not in ("feed", "fetch"):
                    v.dist_attr = rules.spec_for(v.name, v.shape)
                    if tuple(v.dist_attr or ()):
                        annotated += 1
            if annotated == 0:
                warnings.warn(
                    "enable_tensor_parallel: no parameter matched the "
                    "shard rules (param naming may not follow the "
                    "attn_*/ffn* conventions) — serving will run "
                    "REPLICATED; pass AnalysisConfig.shard_rules with "
                    "patterns for this model's names")
            self._run_prog = CompiledProgram(self.program).with_mesh(
                config.mesh)

    @property
    def device(self):
        return self._exe.device

    def _cast_params_bf16(self):
        for name in list(self.scope.names()):
            v = self.scope.get(name)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                self.scope.set(name, v.to(torch.bfloat16))

    def _apply_int8(self):
        """The enable_int8 program rewrite: optional activation
        calibration over the configured feeds, then per-output-channel
        weight quant-dequant on every quantizable op (quant/ptq.py).
        Parameters only: the reference-__model__ branch rebuilds weights
        as plain Variables, which apply_ptq skips, so that branch serves
        in float until re-exported with Parameters."""
        from ..observability import _help
        from ..observability.metrics import global_registry
        from ..quant.ptq import apply_ptq, calibrate_program
        scales = {}
        feeds = self.config.int8_calibration_feeds
        if feeds:
            with scope_guard(self.scope):
                scales = calibrate_program(self._exe, self.program, feeds)
        apply_ptq(self.program, scales, weight_granularity="channel")
        ops = self.program.global_block().ops
        self.int8_weight_tensors = sum(
            1 for op in ops
            if op.type in ("fake_quantize_dequantize_abs_max",
                           "fake_channel_wise_quantize_dequantize_"
                           "abs_max"))
        self.int8_calibrated_activations = sum(
            1 for op in ops
            if op.type == "quantize_dequantize_static_scale")
        reg = global_registry()
        reg.counter("inference.int8.weights",
                    _help("inference.int8.weights")).inc(
                        self.int8_weight_tensors)
        reg.counter(
            "inference.int8.calibrated_activations",
            _help("inference.int8.calibrated_activations")).inc(
                self.int8_calibrated_activations)

    # -- the reference's ZeroCopyRun / run APIs ---------------------------
    def run(self, feeds):
        """feeds: {name: array}, or a list in get_input_names() order.
        Returns the fetches as numpy arrays, in get_output_names() order
        (a bf16 fetch widened to f32)."""
        if isinstance(feeds, (list, tuple)):
            feeds = dict(zip(self.feed_names, feeds))
        if self.config.use_bf16:
            feeds = {k: (np.asarray(v, np.float32)
                         if np.asarray(v).dtype.kind == "f" else v)
                     for k, v in feeds.items()}
        with scope_guard(self.scope):
            return self._exe.run(self._run_prog, feed=feeds,
                                 fetch_list=self.fetch_names)

    __call__ = run

    def predict_batch(self, feeds):
        """The bucket-padded batch path: pad the batch dim up to the
        nearest bucket and return only the real rows; a request past the
        largest bucket is split into largest-bucket chunks."""
        if not self.config.fixed_batch_sizes:
            return self.run(feeds)
        if isinstance(feeds, (list, tuple)):
            feeds = dict(zip(self.feed_names, feeds))
        n = next(iter(feeds.values())).shape[0]
        largest = self.config.fixed_batch_sizes[-1]
        if n > largest:
            chunks = []
            for s in range(0, n, largest):
                chunks.append(self.predict_batch(
                    {k: np.asarray(v)[s:s + largest]
                     for k, v in feeds.items()}))
            return [np.concatenate(parts) for parts in zip(*chunks)]
        bucket = next(b for b in self.config.fixed_batch_sizes if b >= n)
        padded = {k: np.concatenate(
            [np.asarray(v)] + [np.zeros_like(np.asarray(v)[:1])] * (bucket - n))
            if bucket > n else np.asarray(v) for k, v in feeds.items()}
        outs = self.run(padded)
        return [o[:n] for o in outs]

    def warmup(self, example_feeds_list):
        """Run each expected signature once (parity: the reference's
        warmup passes): the kernels' libraries build, and the allocator's
        pools fill, before the serving path sees a request."""
        for feeds in example_feeds_list:
            self.run(feeds)
        return self

    def generation_server(self, **overrides):
        """A ``serving.GenerationServer`` over this predictor's loaded
        parameters, on its device (requires
        ``AnalysisConfig.enable_generation``). The scope must hold
        models/gpt.py's gpt_* parameter names: the export came from a
        GPT-family program. Under enable_bf16 the model and its KV pool
        are bf16; under enable_int8 its matmul weights are int8 and the
        pool defaults to int8."""
        if self.config.generation is None:
            raise RuntimeError(
                "generation not enabled: call "
                "AnalysisConfig.enable_generation(gpt_config, ...) "
                "before create_predictor")
        from ..serving import GenerationServer, GPTServingModel
        opts = dict(self.config.generation)
        opts.update(overrides)
        gpt_cfg = opts.pop("gpt_config")
        dtype = torch.bfloat16 if self.config.use_bf16 else None
        model = GPTServingModel.from_scope(self.scope, gpt_cfg,
                                           device=self.device, dtype=dtype)
        if self.config.use_int8:
            # quantized SERVING end to end: int8 weights in the fused
            # step AND int8 KV blocks (kv_dtype stays overridable)
            model.quantize_int8()
            opts.setdefault("kv_dtype", "int8")
        opts.setdefault("device", self.device)
        return GenerationServer(model, **opts)

    def get_input_names(self):
        return list(self.feed_names)

    def get_output_names(self):
        return list(self.fetch_names)


def create_predictor(config_or_dir):
    if isinstance(config_or_dir, str):
        config_or_dir = AnalysisConfig(config_or_dir)
    return Predictor(config_or_dir)
