"""Model statistics: parameter and FLOP counting.

Parity: the reference-era ``paddle.fluid.contrib.model_stat.summary``,
which walks the ProgramDesc counting parameters and multiply-adds per op;
the port's own copy of ``paddle_tpu/utils/model_stat.py``. The walk is
over the Program's declared shapes (nothing runs); the FLOP rules cover
the products (mul, matmul, conv, attention) plus one operation per output
element of the elementwise ops. ``observability/compile_insight.py``'s
``analyze_program`` reads ``count_flops`` for its per-op-type
attribution.
"""

_ELEMENTWISE_PREFIXES = ("elementwise_", "relu", "gelu", "sigmoid", "tanh",
                         "softmax", "scale", "dropout")


def _numel(shape, batch=1):
    n = 1
    for d in shape or ():
        n *= batch if d in (-1, None) else int(d)
    return n


def count_params(program):
    """(total_param_count, {name: count})"""
    per = {p.name: _numel(p.shape) for p in program.all_parameters()}
    return sum(per.values()), per


def _var_shape(block, name):
    v = block.vars.get(name)
    return None if v is None else v.shape


def count_flops(program, batch_size=1):
    """Forward multiply-add FLOPs (x2) per op type, -1 dims resolved to
    `batch_size`. Returns (total, per_op)."""
    total = 0
    per_op = {}
    gb = program.global_block()
    for op in gb.ops:
        flops = 0
        if op.type in ("mul", "matmul"):
            xs = _var_shape(gb, op.input("X")[0])
            ys = _var_shape(gb, op.input("Y")[0])
            if xs and ys:
                m = _numel(xs[:-1], batch_size)
                k = xs[-1] if xs[-1] not in (-1, None) else 1
                n = ys[-1] if ys[-1] not in (-1, None) else 1
                flops = 2 * m * k * n
        elif op.type in ("conv2d", "depthwise_conv2d", "conv2d_transpose"):
            out = _var_shape(gb, op.output_names[0])
            w = _var_shape(gb, op.input("Filter")[0])
            if out and w:
                flops = 2 * _numel(out, batch_size) * _numel(w[1:])
        elif op.type == "multihead_attention":
            # 4 projections (M x M) + the 2 score/value products, at the
            # algorithmic T^2 cost whatever the flash kernel skips (the
            # usual MFU accounting)
            qs = _var_shape(gb, op.input("Query")[0])
            if qs and len(qs) >= 2:
                t, m = int(qs[-2]), int(qs[-1])
                bsz = batch_size if qs[0] in (-1, None) else int(qs[0])
                flops = bsz * (4 * 2 * t * m * m + 2 * 2 * t * t * m)
        elif op.type == "scaled_dot_product_attention":
            qs = _var_shape(gb, op.input("Q")[0])
            if qs and len(qs) == 4:
                bsz = batch_size if qs[0] in (-1, None) else int(qs[0])
                h, t, dh = int(qs[1]), int(qs[2]), int(qs[3])
                flops = 2 * 2 * bsz * h * t * t * dh
        elif op.type.startswith(_ELEMENTWISE_PREFIXES):
            out = _var_shape(gb, op.output_names[0])
            if out:
                flops = _numel(out, batch_size)
        if flops:
            total += flops
            per_op[op.type] = per_op.get(op.type, 0) + flops
    return total, per_op


def summary(program, batch_size=1, print_fn=print):
    """Human summary table (parity: contrib.model_stat.summary)."""
    n_params, _ = count_params(program)
    flops, per_op = count_flops(program, batch_size)
    print_fn(f"params: {n_params / 1e6:.3f} M")
    print_fn(f"fwd FLOPs @ batch {batch_size}: {flops / 1e9:.3f} G")
    for k, v in sorted(per_op.items(), key=lambda kv: -kv[1]):
        print_fn(f"  {k:24s} {v / 1e9:10.3f} G")
    return {"params": n_params, "flops": flops, "per_op": per_op}
