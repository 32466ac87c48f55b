"""Optimizer wrappers: EMA, ModelAverage, Lookahead, GradientMerge.

Parity: fluid.optimizer.{ExponentialMovingAverage, ModelAverage,
LookaheadOptimizer, GradientMergeOptimizer}; the counterpart of
``paddle_tpu/optimizer/wrappers.py``, op for op. State lives in
persistable Scope vars; the periodic Lookahead sync and the gradient-merge
apply step are branch-free selects on a bounded step counter, so a step
stays one walk of the same ops, with no host read.

The port's optimizers update the scope's tensors in place, where JAX
returns new arrays. So the snapshot that gradient merge's select reads is
an ``assign``, which copies (``ops/tensor_ops.py``), taken before the
update ops run; the select writes a new tensor. ``apply()`` swaps in new
tensors and stashes the training tensors themselves, which nothing
updates while they are stashed, so ``restore()`` brings them back bit for
bit.
"""

from ..core import unique_name
from ..core.framework import default_main_program
from ..core.layer_helper import LayerHelper
from ..core.executor import global_scope
from .. import initializer as init_mod


class _SwapContext:
    """Returned by the wrappers' apply(): the swap has already happened
    when this object exists (fluid's apply(executor) runs its swap
    eagerly), so both call styles work:

        with ema.apply(exe): evaluate()            # restores on exit
        ema.apply(exe, need_restore=False)         # a bare call swaps too
        evaluate(); ema.restore(exe)

    Leaving the context unwinds ONE apply frame (a nested `with` keeps the
    outer swap live); a bare restore() unwinds the whole stack back to the
    training weights."""

    def __init__(self, owner, need_restore):
        self._owner = owner
        self._need_restore = need_restore

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._need_restore:
            self._owner._restore_frame()
        return False


class _SwapStackMixin:
    """The stash shared by EMA and ModelAverage: each apply() pushes
    {param: the tensor it replaced}; frames unwind LIFO, so the training
    weights land last."""

    def _push_frame(self, frame):
        if not hasattr(self, "_backup_stack"):
            self._backup_stack = []
        self._backup_stack.append(frame)

    def _restore_frame(self):
        scope = global_scope()
        stack = getattr(self, "_backup_stack", [])
        if stack:
            for name, val in stack.pop().items():
                scope.set(name, val)

    def restore(self, executor=None):
        """Parity: fluid's restore(executor): bring back the training
        weights stashed by apply(), however many applies deep."""
        while getattr(self, "_backup_stack", []):
            self._restore_frame()


def _scalar(scope, name, default):
    t = scope.get(name) if name else None
    return default if t is None else float(t.reshape(-1)[0])


class ExponentialMovingAverage(_SwapStackMixin):
    """Parity: fluid.optimizer.ExponentialMovingAverage:
    EMA_t = decay EMA_{t-1} + (1 - decay) theta_t; apply() divides by the
    bias correction 1 - decay^t; with thres_steps the decay is
    min(decay, (t + 1) / (t + 10))."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._thres_steps = thres_steps
        self._name = name or ""
        self._ema_vars = {}
        self._params = []
        self._count_name = None
        self._decay_name = None

    def update(self):
        """Append the EMA update ops for every trainable parameter (call
        after optimizer.minimize, as fluid does)."""
        helper = LayerHelper("ema")
        program = default_main_program()
        block = program.global_block()
        cnt = helper.create_global_variable(
            persistable=True, name=unique_name.generate("ema_step"),
            shape=(), dtype="float32")
        cnt.stop_gradient = True
        init_mod.ConstantInitializer(0.0)(cnt)
        self._count_name = cnt.name
        block.append_op("increment", {"X": cnt}, {"Out": cnt}, {"step": 1.0})
        decay_var = helper.create_global_variable(
            persistable=True, name=unique_name.generate("ema_decay"),
            shape=(), dtype="float32")
        decay_var.stop_gradient = True
        init_mod.ConstantInitializer(self._decay)(decay_var)
        self._decay_name = decay_var.name
        if self._thres_steps is not None:
            t = self._thres_steps
            num = helper.create_variable_for_type_inference("float32", t.shape)
            den = helper.create_variable_for_type_inference("float32", t.shape)
            block.append_op("cast", {"X": t}, {"Out": num},
                            {"out_dtype": "float32"})
            block.append_op("scale", {"X": num}, {"Out": den},
                            {"scale": 1.0, "bias": 10.0})
            block.append_op("scale", {"X": num}, {"Out": num},
                            {"scale": 1.0, "bias": 1.0})
            ratio = helper.create_variable_for_type_inference("float32",
                                                              t.shape)
            block.append_op("elementwise_div", {"X": num, "Y": den},
                            {"Out": ratio}, {"axis": -1})
            cap = helper.create_variable_for_type_inference("float32", ())
            block.append_op("fill_constant", {}, {"Out": cap},
                            {"shape": [], "dtype": "float32",
                             "value": self._decay})
            block.append_op("elementwise_min", {"X": ratio, "Y": cap},
                            {"Out": decay_var}, {"axis": -1})
        omd = helper.create_variable_for_type_inference("float32", ())
        block.append_op("scale", {"X": decay_var}, {"Out": omd},
                        {"scale": -1.0, "bias": 1.0})
        for p in program.all_parameters():
            if not p.trainable or getattr(p, "do_model_average",
                                          None) is False:
                continue
            # the accumulator is f32 whatever the parameter's dtype (0.999
            # is 0.996 in bf16); apply() casts back
            ema = helper.create_global_variable(
                persistable=True,
                name=unique_name.generate(p.name + ".ema"),
                shape=p.shape, dtype="float32")
            ema.stop_gradient = True
            init_mod.ConstantInitializer(0.0)(ema)
            self._ema_vars[p.name] = ema.name
            self._params.append(p)
            pf = helper.create_variable_for_type_inference("float32", p.shape)
            block.append_op("cast", {"X": p}, {"Out": pf},
                            {"out_dtype": "float32"})
            scaled = helper.create_variable_for_type_inference(
                "float32", p.shape)
            block.append_op("elementwise_mul", {"X": ema, "Y": decay_var},
                            {"Out": scaled}, {"axis": -1})
            contrib = helper.create_variable_for_type_inference(
                "float32", p.shape)
            block.append_op("elementwise_mul", {"X": pf, "Y": omd},
                            {"Out": contrib}, {"axis": -1})
            block.append_op("elementwise_add", {"X": scaled, "Y": contrib},
                            {"Out": ema}, {"axis": -1})

    def apply(self, executor=None, need_restore=True):
        """Swap the parameters to their bias-corrected EMA values now
        (new tensors, the training ones stashed); returns a context that
        restores on exit unless need_restore=False, in which case call
        restore() when done. Reads the step count and the decay from the
        scope (a host read, once a call)."""
        scope = global_scope()
        t = _scalar(scope, self._count_name, 0.0)
        d = _scalar(scope, self._decay_name, self._decay)
        corr = 1.0 - d ** t if t > 0 else 1.0
        frame = {}
        for p in self._params:
            ema = scope.get(self._ema_vars[p.name])
            cur = scope.get(p.name)
            if ema is None or cur is None:
                continue
            frame[p.name] = cur
            scope.set(p.name, (ema / corr).to(cur.dtype))
        self._push_frame(frame)
        return _SwapContext(self, need_restore)


class ModelAverage(_SwapStackMixin):
    """Parity: fluid.optimizer.ModelAverage, the running average of the
    parameters. As in the JAX package, apply() averages over every update
    since startup (the reference's three-tier window restricted to
    max_average_window updates is not kept)."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        self._sums = {}
        self._count_name = unique_name.generate("model_average_count")
        self._params = []
        helper = LayerHelper("model_average")
        program = default_main_program()
        block = program.global_block()
        cnt = helper.create_global_variable(persistable=True,
                                            name=self._count_name, shape=(),
                                            dtype="float32")
        cnt.stop_gradient = True
        init_mod.ConstantInitializer(0.0)(cnt)
        block.append_op("increment", {"X": cnt}, {"Out": cnt}, {"step": 1.0})
        for p in program.all_parameters():
            if not p.trainable or getattr(p, "do_model_average",
                                          None) is False:
                continue
            # an f32 sum (a bf16 one saturates after ~256 steps)
            s = helper.create_global_variable(
                persistable=True, name=unique_name.generate(p.name + ".sum"),
                shape=p.shape, dtype="float32")
            s.stop_gradient = True
            init_mod.ConstantInitializer(0.0)(s)
            pf = helper.create_variable_for_type_inference("float32", p.shape)
            block.append_op("cast", {"X": p}, {"Out": pf},
                            {"out_dtype": "float32"})
            block.append_op("elementwise_add", {"X": s, "Y": pf}, {"Out": s},
                            {"axis": -1})
            self._sums[p.name] = s.name
            self._params.append(p)

    def apply(self, executor=None, need_restore=True):
        """Swap the parameters to their running average now; restore on
        context exit, or by restore() after apply(need_restore=False)."""
        scope = global_scope()
        cnt = scope.get(self._count_name)
        frame = {}
        for p in self._params:
            s, cur = scope.get(self._sums[p.name]), scope.get(p.name)
            if s is None or cur is None:
                continue
            frame[p.name] = cur
            avg = s / cnt.clamp_min(1.0) if cnt is not None else s.clone()
            scope.set(p.name, avg.to(cur.dtype))
        self._push_frame(frame)
        return _SwapContext(self, need_restore)


def _periodic_flag(helper, block, k, counter_name):
    """Append a k-periodic gate: a persistable counter stepping
    (cnt + 1) mod k (bounded, so an f32 counter never saturates at 2^24),
    and (flag, inv) floats with flag 1.0 every k-th step."""
    cnt = helper.create_global_variable(
        persistable=True, name=unique_name.generate(counter_name),
        shape=(), dtype="float32")
    cnt.stop_gradient = True
    init_mod.ConstantInitializer(0.0)(cnt)
    block.append_op("increment", {"X": cnt}, {"Out": cnt}, {"step": 1.0})
    kconst = helper.create_variable_for_type_inference("float32", ())
    block.append_op("fill_constant", {}, {"Out": kconst},
                    {"shape": [], "dtype": "float32", "value": float(k)})
    block.append_op("elementwise_mod", {"X": cnt, "Y": kconst},
                    {"Out": cnt}, {"axis": -1})
    zero = helper.create_variable_for_type_inference("float32", ())
    block.append_op("fill_constant", {}, {"Out": zero},
                    {"shape": [], "dtype": "float32", "value": 0.0})
    flag_b = helper.create_variable_for_type_inference("bool", ())
    block.append_op("equal", {"X": cnt, "Y": zero}, {"Out": flag_b})
    flag = helper.create_variable_for_type_inference("float32", ())
    block.append_op("cast", {"X": flag_b}, {"Out": flag},
                    {"out_dtype": "float32"})
    inv = helper.create_variable_for_type_inference("float32", ())
    block.append_op("scale", {"X": flag}, {"Out": inv},
                    {"scale": -1.0, "bias": 1.0})
    return flag, inv


def _select(helper, block, flag, inv, new, old, out):
    """out = flag new + (1 - flag) old (branch-free periodic select)."""
    a = helper.create_variable_for_type_inference(new.dtype, new.shape)
    block.append_op("elementwise_mul", {"X": new, "Y": flag},
                    {"Out": a}, {"axis": -1})
    b = helper.create_variable_for_type_inference(new.dtype, new.shape)
    block.append_op("elementwise_mul", {"X": old, "Y": inv},
                    {"Out": b}, {"axis": -1})
    block.append_op("elementwise_add", {"X": a, "Y": b},
                    {"Out": out}, {"axis": -1})


class LookaheadOptimizer:
    """Parity: fluid.optimizer.LookaheadOptimizer: the inner optimizer
    steps the fast weights; every k-th step slow += alpha (fast - slow)
    and fast snaps to slow."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        from ..core.framework import Variable, default_startup_program
        opt_ops, params_grads = self.inner_optimizer.minimize(
            loss, startup_program)
        helper = LayerHelper("lookahead")
        program = loss.block.program
        block = program.global_block()
        sync, inv = _periodic_flag(helper, block, self.k, "lookahead_step")
        sblock = (startup_program or default_startup_program()).global_block()
        for p, _ in params_grads:
            slow = helper.create_global_variable(
                persistable=True, name=unique_name.generate(p.name + ".slow"),
                shape=p.shape, dtype=p.dtype)
            slow.stop_gradient = True
            # slow starts AT the parameter (the reference's startup
            # assign), a copy of it: the optimizer updates p in place
            s_out = Variable(sblock, name=slow.name, shape=slow.shape,
                             dtype=slow.dtype, persistable=True)
            sblock.vars[slow.name] = s_out
            if p.name not in sblock.vars:
                raise RuntimeError(
                    f"LookaheadOptimizer: param {p.name} has no startup "
                    "initializer; call minimize after building the net")
            sblock.append_op("assign", {"X": sblock.vars[p.name]},
                             {"Out": s_out})
            # slow' = slow + alpha (fast - slow), on sync steps only
            diff = helper.create_variable_for_type_inference(p.dtype, p.shape)
            block.append_op("elementwise_sub", {"X": p, "Y": slow},
                            {"Out": diff}, {"axis": -1})
            step_ = helper.create_variable_for_type_inference(p.dtype,
                                                              p.shape)
            block.append_op("scale", {"X": diff}, {"Out": step_},
                            {"scale": self.alpha})
            cand = helper.create_variable_for_type_inference(p.dtype, p.shape)
            block.append_op("elementwise_add", {"X": slow, "Y": step_},
                            {"Out": cand}, {"axis": -1})
            _select(helper, block, sync, inv, cand, slow, slow)
            # fast = sync slow' + (1 - sync) fast
            _select(helper, block, sync, inv, slow, p, p)
        return opt_ops, params_grads


class GradientMergeOptimizer:
    """K-step gradient accumulation with a gated update.

    Parity: fluid.optimizer.GradientMergeOptimizer. Every step adds the
    fresh gradient into a persistable accumulator; every k-th step the
    inner optimizer applies the (averaged) merged gradient and the
    accumulator resets. Off-steps leave the parameters and the optimizer's
    state (momenta, Adam's moments, beta pows) bit for bit as they were:
    the update section is wrapped in snapshot (an ``assign``, a copy)
    -> update (in place) -> select, the counter gating Lookahead uses.
    """

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner_optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..core.framework import (Operator, default_startup_program,
                                      program_guard)
        if self.k_steps <= 1:
            return self.inner_optimizer.minimize(
                loss, startup_program, parameter_list, no_grad_set)
        helper = LayerHelper("gradient_merge")
        program = loss.block.program
        block = program.global_block()
        # the counter, accumulators, temporaries and their initializers go
        # into loss's programs, whatever the ambient defaults are
        with program_guard(program,
                           startup_program or default_startup_program()):
            params_grads = self.inner_optimizer.backward(
                loss, startup_program, parameter_list, no_grad_set)
            apply_f, inv = _periodic_flag(helper, block, self.k_steps,
                                          "grad_merge_step")
            accs = []
            for p, g in params_grads:
                acc = helper.create_global_variable(
                    persistable=True,
                    name=unique_name.generate(p.name + ".grad_merge"),
                    shape=p.shape, dtype=p.dtype)
                acc.stop_gradient = True
                init_mod.ConstantInitializer(0.0)(acc)
                block.append_op("elementwise_add", {"X": acc, "Y": g},
                                {"Out": acc}, {"axis": -1})
                # the update consumes g := acc apply (/k with avg); on an
                # off-step g is 0 and the select below reverts the state
                merged = helper.create_variable_for_type_inference(
                    g.dtype, g.shape)
                block.append_op("elementwise_mul",
                                {"X": acc, "Y": apply_f},
                                {"Out": merged}, {"axis": -1})
                block.append_op("scale", {"X": merged}, {"Out": g},
                                {"scale": (1.0 / self.k_steps)
                                 if self.avg else 1.0})
                accs.append(acc)

            self.inner_optimizer._create_global_learning_rate(program)
            pre = len(block.ops)
            optimize_ops = self.inner_optimizer.apply_gradients(
                params_grads)

            # every persistable the update section writes is gated:
            # snapshot -> select (params, momenta, beta pows, ...)
            written, seen = [], set()
            for op in block.ops[pre:]:
                for name in op.output_names:
                    v = block.vars.get(name)
                    if v is not None and v.persistable \
                            and name not in seen:
                        seen.add(name)
                        written.append(v)
            snap_ops, snaps = [], {}
            for v in written:
                if not str(v.dtype).startswith(("float", "bfloat")):
                    raise NotImplementedError(
                        f"gradient merge cannot gate non-float optimizer "
                        f"state var {v.name!r} ({v.dtype})")
                tmp = helper.create_variable_for_type_inference(v.dtype,
                                                                v.shape)
                snap_ops.append(Operator(block, "assign", {"X": v},
                                         {"Out": tmp}))
                snaps[v.name] = tmp
            block.ops[pre:pre] = snap_ops
            for v in written:
                _select(helper, block, apply_f, inv, v, snaps[v.name], v)
            # the accumulators reset on apply steps
            for acc in accs:
                block.append_op("elementwise_mul", {"X": acc, "Y": inv},
                                {"Out": acc}, {"axis": -1})
        program._bump_version()
        return optimize_ops, params_grads
