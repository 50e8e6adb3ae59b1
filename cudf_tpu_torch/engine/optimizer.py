"""Plan optimizer (port of ``cudf_tpu/engine/optimizer.py``): adjacent
filters fused, a filter over a file ``Scan`` pushed into it, projections
pushed down to the sources (in-memory tables and file scans), and
structurally equal subplans shared.
"""

from __future__ import annotations

import copy
from typing import Optional, Set

from cudf_tpu_torch.engine import ir as IRs


def optimize(node: IRs.IR) -> IRs.IR:
    node = push_predicates(node)
    node = push_projections(node, needed=None)
    return cse(node)


# ----------------------------------------------------------------------
# common-subplan elimination: structurally equal subtrees collapse to one
# shared node, so IR.evaluate's id-keyed cache computes them once
# ----------------------------------------------------------------------

def cse(node: IRs.IR) -> IRs.IR:
    seen = {}

    def fingerprint(n: IRs.IR, child_fps) -> str:
        parts = [type(n).__name__]
        for k, v in sorted(vars(n).items()):
            if k == "children":
                continue
            if isinstance(v, (str, int, float, bool, type(None))):
                parts.append(f"{k}={v!r}")
            elif isinstance(v, (list, tuple)):
                parts.append(f"{k}={[repr(x) for x in v]}")
            else:
                # tables, columns, expressions: by identity (conservative)
                parts.append(f"{k}@{id(v)}")
        parts.extend(child_fps)
        return "|".join(parts)

    def walk(n: IRs.IR):
        child_results = [walk(c) for c in n.children]
        new_children = tuple(c for _, c in child_results)
        if any(a is not b for a, b in zip(new_children, n.children)):
            n = copy.copy(n)
            n.children = new_children
        fp = fingerprint(n, [fp for fp, _ in child_results])
        if fp in seen:
            return fp, seen[fp]
        seen[fp] = n
        return fp, n

    return walk(node)[1]


# ----------------------------------------------------------------------
# predicate pushdown: adjacent filters fused into one
# ----------------------------------------------------------------------

def push_predicates(node: IRs.IR) -> IRs.IR:
    node = _rewrite_children(node, push_predicates)
    if isinstance(node, IRs.Filter):
        child = node.children[0]
        if isinstance(child, IRs.Scan) and child.predicate is None:
            return IRs.Scan(child.fmt, child.paths, child.projection, node.predicate,
                            device=child.device)
        if isinstance(child, IRs.Filter):
            return push_predicates(IRs.Filter(child.children[0],
                                              child.predicate & node.predicate))
    return node


# ----------------------------------------------------------------------
# projection pushdown: a source gives only the columns the plan reads
# ----------------------------------------------------------------------

def push_projections(node: IRs.IR, needed: Optional[Set[str]]) -> IRs.IR:
    if isinstance(node, IRs.Scan):
        if needed is not None and node.projection is None:
            avail = IRs.file_columns(node.fmt, node.paths[0])
            return IRs.Scan(node.fmt, node.paths, [c for c in avail if c in needed],
                            node.predicate, device=node.device)
        return node
    if isinstance(node, IRs.DataFrameScan):
        if needed is not None and node.projection is None:
            return IRs.DataFrameScan(node.table, [n for n in node.table.names if n in needed])
        return node
    if isinstance(node, IRs.Select):
        child_needed = set()
        for e in node.exprs:
            child_needed |= e.references()
        return IRs.Select(push_projections(node.children[0], child_needed), node.exprs)
    if isinstance(node, IRs.HStack):
        child_needed = None
        if needed is not None:
            child_needed = set(needed)
            for e in node.exprs:
                child_needed |= e.references()
        return IRs.HStack(push_projections(node.children[0], child_needed), node.exprs)
    if isinstance(node, IRs.Filter):
        child_needed = None if needed is None else set(needed) | node.predicate.references()
        return IRs.Filter(push_projections(node.children[0], child_needed), node.predicate)
    if isinstance(node, IRs.GroupBy):
        child_needed = set(node.keys)
        for a in node.aggs:
            child_needed |= a.references()
        return IRs.GroupBy(push_projections(node.children[0], child_needed),
                           node.keys, node.aggs)
    if isinstance(node, IRs.Reduce):
        child_needed = set()
        for a in node.aggs:
            child_needed |= a.references()
        return IRs.Reduce(push_projections(node.children[0], child_needed), node.aggs)
    if isinstance(node, IRs.Join):
        ln = rn = None
        if needed is not None:
            # a right column read as <name><suffix> needs <name> on both
            # sides: the clash is what suffixes it (the reference keeps
            # only the suffixed name and loses the column)
            k = len(node.suffix)
            clashes = {n[:-k] for n in needed
                       if k and isinstance(n, str) and n.endswith(node.suffix)}
            ln = set(node.left_on) | set(needed) | clashes
            rn = set(node.right_on) | set(needed) | clashes
        return IRs.Join(push_projections(node.children[0], ln),
                        push_projections(node.children[1], rn),
                        node.left_on, node.right_on, node.how, node.suffix)
    if isinstance(node, IRs.Sort):
        child_needed = None if needed is None else set(needed) | set(node.by)
        return IRs.Sort(push_projections(node.children[0], child_needed),
                        node.by, node.descending, node.nulls_last)
    if isinstance(node, IRs.Projection):
        return IRs.Projection(push_projections(node.children[0], set(node.columns)),
                              node.columns)
    # default: recurse without narrowing
    return _rewrite_children(node, lambda c: push_projections(c, None))


def _rewrite_children(node: IRs.IR, fn) -> IRs.IR:
    if not node.children:
        return node
    new_children = tuple(fn(c) for c in node.children)
    if all(a is b for a, b in zip(new_children, node.children)):
        return node
    out = copy.copy(node)
    out.children = new_children
    return out
