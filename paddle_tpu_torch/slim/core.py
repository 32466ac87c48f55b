"""Slim compression pipeline: Context / Strategy / Compressor / config.

Parity: python/paddle/fluid/contrib/slim/core/ (compressor.py:30 Context,
compressor.py:135 Compressor, strategy.py:20 Strategy, config.py:29
ConfigFactory); the counterpart of ``paddle_tpu/slim/core.py``.

The reference's user contract: a yaml-configured strategy pipeline driven
epoch by epoch over a train program, here with the port's Executor
underneath (`place` None means the card). ``yaml`` is imported only when
a config is read.
"""

import importlib
import logging

import numpy as np

from ..core.executor import Executor, Scope, global_scope, scope_guard
from .graph import GraphWrapper, SlimGraphExecutor  # noqa: F401

__all__ = ["Context", "Strategy", "Compressor", "ConfigFactory"]

_logger = logging.getLogger("slim")


class Strategy:
    """Epoch-ranged hook bundle (ref strategy.py:20): subclasses override
    any of the on_* hooks; the compressor fires them in order."""

    def __init__(self, start_epoch=0, end_epoch=0):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch

    def on_compression_begin(self, context):
        pass

    def on_epoch_begin(self, context):
        pass

    def on_epoch_end(self, context):
        pass

    def on_batch_begin(self, context):
        pass

    def on_batch_end(self, context):
        pass

    def on_compression_end(self, context):
        pass


class Context:
    """Mutable pipeline state threaded through strategy hooks
    (ref compressor.py:30)."""

    def __init__(self, place=None, scope=None, train_graph=None,
                 eval_graph=None, optimize_graph=None, epoch_id=0,
                 batch_id=0, eval_reader=None, eval_feed_list=None,
                 teacher_graphs=None, train_optimizer=None,
                 distiller_optimizer=None):
        self.place = place
        self.scope = scope if scope is not None else global_scope()
        self.train_graph = train_graph
        self.eval_graph = eval_graph
        self.optimize_graph = optimize_graph
        self.epoch_id = epoch_id
        self.batch_id = batch_id
        self.eval_reader = eval_reader
        self.eval_feed_list = list(eval_feed_list or [])
        self.teacher_graphs = teacher_graphs or []
        self.train_optimizer = train_optimizer
        self.distiller_optimizer = distiller_optimizer
        self.eval_results = {}
        self.k_v = {}

    def put(self, key, value):
        self.k_v[key] = value

    def get(self, key):
        return self.k_v.get(key)

    def eval_result_tail(self, metric):
        r = self.eval_results.get(metric)
        return r[-1] if r else None


class Compressor:
    """Epoch driver (ref compressor.py:135): builds a Context, fires
    strategy hooks around a plain train loop, evaluates per epoch.

    feed lists are var NAMES (our feed contract); fetch lists are vars
    or names. Strategies come from __init__ or from config() yaml.
    """

    def __init__(self, place, scope, train_program, train_reader=None,
                 train_feed_list=None, train_fetch_list=None,
                 eval_program=None, eval_reader=None, eval_feed_list=None,
                 eval_fetch_list=None, teacher_programs=(),
                 checkpoint_path=None, train_optimizer=None,
                 distiller_optimizer=None, epoch=1, strategies=None):
        self.place = place
        self.scope = scope if scope is not None else Scope()
        self.train_graph = GraphWrapper(
            train_program,
            out_nodes={i: n for i, n in
                       enumerate(_names(train_fetch_list))})
        self.eval_graph = (GraphWrapper(
            eval_program,
            out_nodes={i: n for i, n in enumerate(_names(eval_fetch_list))})
            if eval_program is not None else None)
        self.train_reader = train_reader
        self.train_feed_list = list(train_feed_list or [])
        self.train_fetch_list = _names(train_fetch_list)
        self.eval_reader = eval_reader
        self.eval_feed_list = list(eval_feed_list or [])
        self.eval_fetch_list = _names(eval_fetch_list)
        self.teacher_graphs = [GraphWrapper(p) for p in teacher_programs]
        self.checkpoint_path = checkpoint_path
        self.train_optimizer = train_optimizer
        self.distiller_optimizer = distiller_optimizer
        self.epoch = epoch
        self.strategies = list(strategies or [])

    def config(self, config_file):
        """Load strategies + epoch from a yaml config
        (ref compressor.py config(); format: ConfigFactory)."""
        factory = ConfigFactory(config_file)
        comp = factory.compressor
        self.epoch = int(comp.get("epoch", self.epoch))
        if comp.get("checkpoint_path"):
            self.checkpoint_path = comp["checkpoint_path"]
        self.strategies.extend(factory.instance(name)
                               for name in comp.get("strategies", []))
        return self

    def run(self):
        exe = Executor(self.place)
        context = Context(place=self.place, scope=self.scope,
                          train_graph=self.train_graph,
                          eval_graph=self.eval_graph,
                          eval_reader=self.eval_reader,
                          eval_feed_list=self.eval_feed_list,
                          teacher_graphs=self.teacher_graphs,
                          train_optimizer=self.train_optimizer,
                          distiller_optimizer=self.distiller_optimizer)
        for s in self.strategies:
            s.on_compression_begin(context)
        for epoch_id in range(self.epoch):
            context.epoch_id = epoch_id
            active = [s for s in self.strategies
                      if s.start_epoch <= epoch_id <= max(s.end_epoch,
                                                          s.start_epoch)]
            for s in active:
                s.on_epoch_begin(context)
            if self.train_reader is not None:
                for batch_id, data in enumerate(self.train_reader()):
                    context.batch_id = batch_id
                    for s in active:
                        s.on_batch_begin(context)
                    feed = dict(zip(self.train_feed_list, data)) \
                        if not isinstance(data, dict) else data
                    with scope_guard(self.scope):
                        exe.run(context.train_graph.program, feed=feed,
                                fetch_list=self.train_fetch_list)
                    for s in active:
                        s.on_batch_end(context)
            for s in active:
                s.on_epoch_end(context)
            self._eval(exe, context)
        for s in self.strategies:
            s.on_compression_end(context)
        return context

    def _eval(self, exe, context):
        if self.eval_graph is None or self.eval_reader is None:
            return
        results = []
        for data in self.eval_reader():
            feed = dict(zip(self.eval_feed_list, data)) \
                if not isinstance(data, dict) else data
            with scope_guard(self.scope):
                out = exe.run(self.eval_graph.program, feed=feed,
                              fetch_list=self.eval_fetch_list)
            results.append([float(np.asarray(v).reshape(-1)[0])
                            for v in out])
        if results:
            means = np.mean(np.asarray(results), axis=0)
            for name, val in zip(self.eval_fetch_list, means):
                context.eval_results.setdefault(name, []).append(float(val))
            _logger.info("epoch %d eval: %s", context.epoch_id,
                         dict(zip(self.eval_fetch_list, means)))


def _names(fetch_list):
    out = []
    for f in (fetch_list or []):
        out.append(f if isinstance(f, str) else f.name)
    return out


class ConfigFactory:
    """yaml strategy factory (ref config.py:29).

    Format (same shape as the reference):

        version: 1.0
        pruners:            # any section defining an object
          pruner_1:
            class: Pruner
        strategies:
          prune_s:
            class: UniformPruneStrategy
            pruner: pruner_1        # reference to another section
            start_epoch: 0
            target_ratio: 0.5
        compressor:
          epoch: 10
          strategies: [prune_s]

    Classes resolve from the slim namespace (paddle_tpu_torch.slim);
    register extras through ConfigFactory.register(cls).
    """

    _REGISTRY = {}

    def __init__(self, config_path_or_dict):
        import yaml
        if isinstance(config_path_or_dict, dict):
            cfg = config_path_or_dict
        else:
            with open(config_path_or_dict) as f:
                cfg = yaml.safe_load(f)
        self._sections = {}
        for key, val in cfg.items():
            if key in ("version", "compressor"):
                continue
            if isinstance(val, dict):
                for name, spec in val.items():
                    if isinstance(spec, dict) and "class" in spec:
                        self._sections[name] = spec
        self.compressor = cfg.get("compressor", {})
        self._cache = {}

    @classmethod
    def register(cls, klass):
        cls._REGISTRY[klass.__name__] = klass
        return klass

    def _resolve_class(self, name):
        if name in self._REGISTRY:
            return self._REGISTRY[name]
        slim = importlib.import_module(__package__)
        if hasattr(slim, name):
            return getattr(slim, name)
        raise ValueError(f"unknown slim class {name!r}; register it via "
                         "ConfigFactory.register")

    def instance(self, name):
        if name in self._cache:
            return self._cache[name]
        spec = dict(self._sections[name])
        klass = self._resolve_class(spec.pop("class"))
        kwargs = {}
        for k, v in spec.items():
            # a string naming another section instantiates recursively
            kwargs[k] = (self.instance(v)
                         if isinstance(v, str) and v in self._sections
                         else v)
        obj = klass(**kwargs)
        self._cache[name] = obj
        return obj
