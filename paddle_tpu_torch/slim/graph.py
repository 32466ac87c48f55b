"""Graph views for slim strategies.

Parity: python/paddle/fluid/contrib/slim/graph/graph_wrapper.py:26
(GraphWrapper/VarWrapper/OpWrapper) and graph/executor.py:21
(SlimGraphExecutor); the counterpart of ``paddle_tpu/slim/graph.py``.

The reference wraps the C++ IrGraph; here the Program is a Python op
list, so the wrappers are thin views the strategies share, with the
same traversal API (ops / vars / pre_ops / next_ops) and no graph copy.
"""

from ..core.framework import Parameter

__all__ = ["GraphWrapper", "VarWrapper", "OpWrapper", "SlimGraphExecutor"]


class VarWrapper:
    def __init__(self, var, graph):
        self._var = var
        self._graph = graph

    def name(self):
        return self._var.name

    def shape(self):
        return tuple(self._var.shape or ())

    def is_parameter(self):
        return isinstance(self._var, Parameter)

    def set_shape(self, shape):
        self._var.shape = tuple(shape)

    def __eq__(self, other):
        return isinstance(other, VarWrapper) and \
            self._var.name == other._var.name

    def __hash__(self):
        return hash(self._var.name)

    def __repr__(self):
        return f"VarWrapper({self._var.name})"


class OpWrapper:
    def __init__(self, op, graph):
        self._op = op
        self._graph = graph

    def type(self):
        return self._op.type

    def idx(self):
        return self._graph.ops().index(self)

    def attr(self, name):
        return self._op.attr(name)

    def set_attr(self, name, value):
        self._op._set_attr(name, value)

    def inputs(self, slot=None):
        names = (self._op.input_names if slot is None
                 else self._op.input(slot))
        return [self._graph.var(n) for n in names
                if self._graph.var(n) is not None]

    def outputs(self, slot=None):
        names = (self._op.output_names if slot is None
                 else self._op.output(slot))
        return [self._graph.var(n) for n in names
                if self._graph.var(n) is not None]

    def __eq__(self, other):
        return isinstance(other, OpWrapper) and self._op is other._op

    def __hash__(self):
        return id(self._op)

    def __repr__(self):
        return f"OpWrapper({self._op.type})"


class GraphWrapper:
    """in_nodes/out_nodes: {logical_name: var_name} like the reference
    (feed targets and fetch targets of the wrapped program)."""

    def __init__(self, program, in_nodes=None, out_nodes=None):
        self.program = program
        self.in_nodes = dict(in_nodes or {})
        self.out_nodes = dict(out_nodes or {})

    def _block(self):
        return self.program.global_block()

    def all_parameters(self):
        return [VarWrapper(v, self) for v in self._block().vars.values()
                if isinstance(v, Parameter)]

    def vars(self):
        return [VarWrapper(v, self) for v in self._block().vars.values()]

    def var(self, name):
        v = self._block().vars.get(name)
        return VarWrapper(v, self) if v is not None else None

    def ops(self):
        return [OpWrapper(op, self) for op in self._block().ops]

    def pre_ops(self, op):
        ins = {v.name() for v in op.inputs()}
        return [o for o in self.ops()
                if ins & {v.name() for v in o.outputs()}]

    def next_ops(self, op):
        outs = {v.name() for v in op.outputs()}
        return [o for o in self.ops()
                if outs & {v.name() for v in o.inputs()}]

    def numel_params(self):
        total = 0
        for p in self.all_parameters():
            n = 1
            for s in p.shape():
                n *= max(int(s), 1)
            total += n
        return total

    def clone(self, for_test=False):
        return GraphWrapper(self.program.clone(for_test=for_test),
                            self.in_nodes, self.out_nodes)


class SlimGraphExecutor:
    """Runs a GraphWrapper through the port's Executor (ref
    graph/executor.py, the same run contract); `place` None means the
    card."""

    def __init__(self, place=None):
        from ..core.executor import Executor
        self.exe = Executor(place)

    def run(self, graph, scope, data=None):
        from ..core.executor import scope_guard
        feed = data if isinstance(data, dict) else None
        fetch_list = [graph.out_nodes[k] for k in sorted(graph.out_nodes)]
        with scope_guard(scope):
            return self.exe.run(graph.program, feed=feed,
                                fetch_list=fetch_list)
