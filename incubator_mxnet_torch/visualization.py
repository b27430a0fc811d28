"""Network visualization (counterpart of
`incubator_mxnet_tpu/visualization.py`): `print_summary`, a text table
of a symbol's layers with the JAX package's parameter count, and
`plot_network`, which needs the `graphviz` package and raises a clear
error without it."""
from __future__ import annotations

from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120):
    """Text table of layers/output shapes/params (ref: print_summary [U])."""
    arg_shapes = {}
    out_shape_of = {}
    if shape:
        arg_s, _, _ = symbol.infer_shape(**shape)
        arg_shapes = dict(zip(symbol.list_arguments(), arg_s))
    order = symbol._topo()
    fields = ["Layer (type)", "Output Shape", "Param #"]
    widths = [max(40, line_length // 3)] * 3
    header = "".join(f"{f:<{w}}" for f, w in zip(fields, widths))
    lines = ["_" * line_length, header, "=" * line_length]
    total = 0
    for node in order:
        if node.is_var():
            continue
        n_params = 0
        for inp in node._inputs:
            if inp.is_var() and not inp._name.endswith(("data", "label")):
                s = arg_shapes.get(inp._name)
                if s:
                    p = 1
                    for d in s:
                        p *= d
                    n_params += p
        total += n_params
        lines.append(
            f"{node._name + ' (' + node._op + ')':<{widths[0]}}"
            f"{'':<{widths[1]}}{n_params:<{widths[2]}}")
    lines += ["=" * line_length, f"Total params: {total}",
              "_" * line_length]
    out = "\n".join(lines)
    print(out)
    return out


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 **kwargs):
    try:
        import graphviz
    except ImportError:
        raise MXNetError(
            "graphviz is not installed in this environment; use "
            "print_summary for a text rendering") from None
    dot = graphviz.Digraph(name=title)
    for node in symbol._topo():
        if node.is_var():
            dot.node(node._name, node._name, shape="oval")
        else:
            dot.node(node._name, f"{node._name}\n{node._op}", shape="box")
            for inp in node._inputs:
                dot.edge((inp._base or inp)._name, node._name)
    return dot
