"""``DataFrame.query`` / ``DataFrame.eval`` (port of
``cudf_tpu/frame/eval_expr.py``; libcudf's AST evaluator,
compute_column.cu).

The expression is parsed by Python's ``ast`` and evaluated node by node
over the frame's Series, each node one elementwise op on the columns'
device.  pandas' query grammar binds ``and``/``or`` (``&``/``|``) looser
than comparisons, so the top level splits on ``|``, then on ``&``, before
each part goes to ``ast``.
"""

from __future__ import annotations

import ast
_BINOPS = {
    ast.Add: "__add__",
    ast.Sub: "__sub__",
    ast.Mult: "__mul__",
    ast.Div: "__truediv__",
    ast.FloorDiv: "__floordiv__",
    ast.Mod: "__mod__",
    ast.Pow: "__pow__",
    ast.BitAnd: "__and__",
    ast.BitOr: "__or__",
    ast.BitXor: "__xor__",
}
_CMPOPS = {
    ast.Eq: "__eq__",
    ast.NotEq: "__ne__",
    ast.Lt: "__lt__",
    ast.Gt: "__gt__",
    ast.LtE: "__le__",
    ast.GtE: "__ge__",
}


def evaluate(df, expr: str):
    expr = expr.replace(" and ", " & ").replace(" or ", " | ").replace("not ", "~")
    return _eval_boolean(df, expr)


def _eval_boolean(df, expr: str):
    """pandas.query grammar gives & and | LOWER precedence than comparisons
    (unlike Python).  Split on top-level |, then top-level &, then hand each
    atom to the Python AST."""
    or_parts = _split_top(expr, "|")
    if len(or_parts) > 1:
        out = _eval_boolean(df, or_parts[0])
        for p in or_parts[1:]:
            out = out | _eval_boolean(df, p)
        return out
    and_parts = _split_top(expr, "&")
    if len(and_parts) > 1:
        out = _eval_boolean(df, and_parts[0])
        for p in and_parts[1:]:
            out = out & _eval_boolean(df, p)
        return out
    tree = ast.parse(expr.strip(), mode="eval")
    return _eval(tree.body, df)


def _split_top(expr: str, sep: str):
    parts = []
    depth = 0
    cur = []
    in_str = None
    for ch in expr:
        if in_str:
            cur.append(ch)
            if ch == in_str:
                in_str = None
            continue
        if ch in "\"'":
            in_str = ch
            cur.append(ch)
        elif ch in "([{":
            depth += 1
            cur.append(ch)
        elif ch in ")]}":
            depth -= 1
            cur.append(ch)
        elif ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _eval(node, df):
    from cudf_tpu_torch.frame.series import Series

    if isinstance(node, ast.BinOp):
        l = _eval(node.left, df)
        r = _eval(node.right, df)
        if isinstance(l, Series):
            return getattr(l, _BINOPS[type(node.op)])(r)
        rd = _BINOPS[type(node.op)].replace("__", "__r", 1)
        return getattr(r, rd)(l)
    if isinstance(node, ast.Compare):
        l = _eval(node.left, df)
        out = None
        for op, comparator in zip(node.ops, node.comparators):
            r = _eval(comparator, df)
            if isinstance(op, (ast.In, ast.NotIn)):
                res = l.isin(r if isinstance(r, (list, tuple)) else [r])
                if isinstance(op, ast.NotIn):
                    res = ~res
            else:
                res = getattr(l, _CMPOPS[type(op)])(r)
            out = res if out is None else (out & res)
            l = r
        return out
    if isinstance(node, ast.BoolOp):
        vals = [_eval(v, df) for v in node.values]
        out = vals[0]
        for v in vals[1:]:
            out = (out & v) if isinstance(node.op, ast.And) else (out | v)
        return out
    if isinstance(node, ast.UnaryOp):
        v = _eval(node.operand, df)
        if isinstance(node.op, ast.Invert) or isinstance(node.op, ast.Not):
            return ~v
        if isinstance(node.op, ast.USub):
            return -v
        return v
    if isinstance(node, ast.Name):
        if node.id in df._table.names:
            return df[node.id]
        if node.id == "index":
            from cudf_tpu_torch.frame.series import Series as S

            return S._from(df._index._column, df._index, None)
        raise NameError(node.id)
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_eval(e, df) for e in node.elts]
    if isinstance(node, ast.Attribute):
        base = _eval(node.value, df)
        return getattr(base, node.attr)
    if isinstance(node, ast.Call):
        func = _eval(node.func, df)
        args = [_eval(a, df) for a in node.args]
        return func(*args)
    if isinstance(node, ast.Subscript):
        base = _eval(node.value, df)
        key = _eval(node.slice, df)
        return base[key]
    raise TypeError(f"unsupported expression node {type(node).__name__}")
