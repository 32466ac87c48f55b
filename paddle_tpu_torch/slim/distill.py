"""Distillation: the loss layers, the program merge and the strategy.

Parity: the reference's slim distillation (soft-label / Hinton KD, FSP
matrix and L2 hint losses added to the student's task loss,
distiller.py, distillation_strategy.py); the counterpart of
``paddle_tpu/slim/distill.py``, built from the port's layers.
``merge_programs`` renames the teacher's variables with a prefix, marks
its parameters non-trainable and moves their scope entries to the new
names.
"""

from .. import layers


def soft_label_loss(student_logits, teacher_logits, temperature=4.0):
    """KL(teacher_T || student_T) * T^2 (Hinton distillation)."""
    t = float(temperature)
    s = layers.softmax(layers.scale(student_logits, scale=1.0 / t))
    p = layers.softmax(layers.scale(teacher_logits, scale=1.0 / t))
    # KL(p||s) = sum p * (log p - log s)
    log_s = layers.log(layers.clip(s, min=1e-8, max=1.0))
    log_p = layers.log(layers.clip(p, min=1e-8, max=1.0))
    kl = layers.reduce_sum(
        layers.elementwise_mul(p, layers.elementwise_sub(log_p, log_s)),
        dim=-1)
    return layers.scale(layers.mean(kl), scale=t * t)


def l2_hint_loss(student_feat, teacher_feat):
    """FitNets hint: L2 between intermediate feature maps."""
    return layers.mean(layers.square_error_cost(student_feat, teacher_feat))


def fsp_loss(student_a, student_b, teacher_a, teacher_b):
    """FSP (flow of solution procedure) matrix distance between two layer
    pairs. Inputs are (N, C, H, W) feature maps; the FSP matrix is the
    HW-averaged Gram matrix between the pair's channels."""
    def fsp_matrix(a, b):
        n = a.shape[0] if a.shape[0] and a.shape[0] > 0 else -1
        ca, cb = a.shape[1], b.shape[1]
        hw = a.shape[2] * a.shape[3]
        af = layers.reshape(a, shape=[n, ca, hw])
        bf = layers.reshape(b, shape=[n, cb, hw])
        g = layers.matmul(af, layers.transpose(bf, perm=[0, 2, 1]))
        return layers.scale(g, scale=1.0 / float(hw))

    gs = fsp_matrix(student_a, student_b)
    gt = fsp_matrix(teacher_a, teacher_b)
    return layers.mean(layers.square_error_cost(gs, gt))


def merge_programs(student_program, teacher_program, prefix="teacher_",
                   share=(), scope=None):
    """Merge a (forward-only) teacher program into the student program.

    Parity: contrib/slim/graph/graph_wrapper.py GraphWrapper.merge — the
    reference splices teacher IR nodes in with renamed vars. Here the
    teacher program is deep-copied, every var/op renamed with `prefix`
    EXCEPT names in `share` (the data inputs both nets read), teacher
    params marked non-trainable, and the result appended into the
    student's global block. When `scope` is given, scope entries for
    renamed persistable vars migrate to the prefixed names (the teacher
    was started/loaded under its original names). Returns the student
    program.
    """
    import copy as _copy
    t = _copy.deepcopy(teacher_program)
    sb = student_program.global_block()
    tb = t.global_block()
    rename = {n: prefix + n for n in tb.vars if n not in share}
    for name, var in tb.vars.items():
        if name in share:
            continue
        var.name = rename[name]
        if hasattr(var, "trainable"):
            var.trainable = False
        if var.name in sb.vars:
            # silently aliasing two same-named teachers corrupts both;
            # the caller must pick distinct prefixes
            raise ValueError(
                f"merge_programs: var {var.name!r} already exists in the "
                f"target program — merge each teacher with a distinct "
                f"prefix")
        sb.vars[var.name] = var
        var.block = sb
    for op in tb.ops:
        op.inputs = {k: [rename.get(n, n) for n in v]
                     for k, v in op.inputs.items()}
        op.outputs = {k: [rename.get(n, n) for n in v]
                      for k, v in op.outputs.items()}
        op.block = sb
        sb.ops.append(op)
    if scope is not None:
        for old, new in rename.items():
            val = scope.get(old)
            if val is not None and scope.get(new) is None:
                scope.set(new, val)
    student_program._bump_version()
    return student_program


class L2Distiller:
    """Parity: contrib/slim/distillation/distiller.py L2Distiller —
    L2 between a student feature and (merged-prefix) teacher feature."""

    def __init__(self, student_feature_map, teacher_feature_map,
                 distillation_loss_weight=1):
        self.student_feature_map = student_feature_map
        self.teacher_feature_map = teacher_feature_map
        self.weight = distillation_loss_weight

    def distiller_loss(self, graph):
        s = graph.var(self.student_feature_map)._var
        t = graph.var(self.teacher_feature_map)._var
        from .. import layers as L
        from ..core.framework import program_guard
        with program_guard(graph.program):
            loss = L.scale(l2_hint_loss(s, t), scale=float(self.weight))
        return loss


class SoftLabelDistiller:
    """Parity: distiller.py SoftLabelDistiller — tempered KD loss."""

    def __init__(self, student_feature_map=None, teacher_feature_map=None,
                 student_temperature=1.0, teacher_temperature=1.0,
                 distillation_loss_weight=1):
        self.student_feature_map = student_feature_map
        self.teacher_feature_map = teacher_feature_map
        self.student_temperature = student_temperature
        self.teacher_temperature = teacher_temperature
        self.weight = distillation_loss_weight

    def distiller_loss(self, graph):
        from .. import layers as L
        from ..core.framework import program_guard
        s = graph.var(self.student_feature_map)._var
        t = graph.var(self.teacher_feature_map)._var
        with program_guard(graph.program):
            # reference applies separate temperatures to each side before
            # the KD term (distiller.py SoftLabelDistillerPass)
            s = L.scale(s, scale=1.0 / float(self.student_temperature))
            t = L.scale(t, scale=1.0 / float(self.teacher_temperature))
            loss = L.scale(soft_label_loss(s, t, temperature=1.0),
                           scale=float(self.weight))
        return loss


class FSPDistiller:
    """Parity: distiller.py FSPDistiller — FSP matrix distance over
    (student_pairs[i], teacher_pairs[i]) feature-map name pairs."""

    def __init__(self, student_pairs, teacher_pairs,
                 distillation_loss_weight=1):
        self.student_pairs = student_pairs
        self.teacher_pairs = teacher_pairs
        self.weight = distillation_loss_weight

    def distiller_loss(self, graph):
        from .. import layers as L
        from ..core.framework import program_guard
        with program_guard(graph.program):
            losses = []
            for (sa, sb), (ta, tb) in zip(self.student_pairs,
                                          self.teacher_pairs):
                losses.append(fsp_loss(graph.var(sa)._var,
                                       graph.var(sb)._var,
                                       graph.var(ta)._var,
                                       graph.var(tb)._var))
            total = losses[0]
            for x in losses[1:]:
                total = L.elementwise_add(total, x)
            total = L.scale(total, scale=float(self.weight))
        return total


from .core import Strategy  # noqa: E402  (after the loss helpers above)


class DistillationStrategy(Strategy):
    """Parity: distillation/distillation_strategy.py — at start_epoch,
    merge the teacher graph(s) into the train graph (first teacher under
    'teacher_', the i-th under 'teacher{i}_'), sum the distiller losses
    onto the task loss, and re-minimize with the distiller optimizer;
    the compressor then trains the combined program."""

    def __init__(self, distillers=None, start_epoch=0, end_epoch=0,
                 task_loss=None, share_vars=()):
        super().__init__(start_epoch, end_epoch)
        self.distillers = list(distillers or [])
        self.task_loss = task_loss
        self.share_vars = tuple(share_vars)

    def on_epoch_begin(self, context):
        if context.epoch_id != self.start_epoch:
            return
        from .. import layers as L
        from ..core.executor import Executor, scope_guard
        from ..core.framework import Program, program_guard
        graph = context.train_graph
        for i, tg in enumerate(context.teacher_graphs):
            prefix = "teacher_" if i == 0 else f"teacher{i}_"
            merge_programs(graph.program, tg.program, prefix=prefix,
                           share=self.share_vars, scope=context.scope)
        losses = [d.distiller_loss(graph) for d in self.distillers]
        # minimize() creates optimizer state (lr var, accumulators) whose
        # initializers land in a FRESH startup program — running the
        # original startup again would re-randomize the nets
        opt_startup = Program()
        with program_guard(graph.program, opt_startup):
            total = losses[0]
            for x in losses[1:]:
                total = L.elementwise_add(total, x)
            if self.task_loss is not None:
                total = L.elementwise_add(
                    total, graph.var(self.task_loss)._var)
            if context.distiller_optimizer is not None:
                context.distiller_optimizer.minimize(total)
        if opt_startup.global_block().ops:
            with scope_guard(context.scope):
                Executor(context.place).run(opt_startup)
        graph.out_nodes["distill_loss"] = total.name
