"""The port's public surface against the reference's, module by module.

For each module of ``cudf_tpu`` (found with ``pkgutil``, without importing
it) the test imports it and its counterpart in ``cudf_tpu_torch`` on the
CPU, and asserts that the counterpart exists and has:

- every public function and class (``__all__`` where the module has one,
  else the functions and classes it defines);
- every public attribute of each such class (``dir``, so attributes that
  loops generate count too);
- the parameter names of each shared function or method (a superset;
  ``*args`` and ``**kwargs`` are catch-alls, not names, and are not
  compared);
- in ``utils/config``, every registered option.

``EXEMPT`` is the one list of differences, ``{qualified name: reason}``,
names relative to the package: ``"native"`` (a module),
``"ops._utils.expand_rows"`` (a name), ``"core.column.Column.from_jnp"``
(an attribute), ``"ops.sort.sorted_order(stable)"`` (a parameter),
``"utils.config[join.kernel_interpret]"`` (an option).  Each reason names
the port's counterpart as a dotted ``cudf_tpu_torch`` path in backticks,
which must resolve, or a bold title of ROADMAP.md's "Do not port" list,
which must stand there.  The user-facing modules (the top level's
``__all__`` and its classes, ``frame/*``, ``engine/*``, the readers and
writers of ``io/*`` and ``pandas/*``) take no exemption but ``to_jax``,
``from_jnp``, the pytree methods, ``kernel_interpret`` and a parameter
that the port names as pandas does (its reason starts "pandas names
it").  Every exemption must still be needed.

Run: ``python -m pytest tests/test_torch_surface.py -q``.
"""

import importlib
import inspect
import pkgutil
import re
import types
from pathlib import Path

import pytest

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu
import cudf_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
DO_NOT_PORT = "ROADMAP.md, Do not port"
PANDAS_NAME = "pandas names it"

EXEMPT = {
    # modules the port fills under another name
    "native": "`cudf_tpu_torch.io._native` builds and binds the host C stages",
    "kernels.bitonic": "`cudf_tpu_torch.kernels.tile_sort` holds tile_sort and "
                       "tile_sort_data (kernels E and F)",
    # JAX buffers and pytrees
    "core.column.Column.from_jnp": "`cudf_tpu_torch.core.column.Column.from_tensor` wraps a "
                                   "torch tensor",
    "core.column.Column.tree_flatten": f"{DO_NOT_PORT}: **JAX pytrees and buffers**",
    "core.column.Column.tree_unflatten": f"{DO_NOT_PORT}: **JAX pytrees and buffers**",
    "core.table.Table.tree_flatten": f"{DO_NOT_PORT}: **JAX pytrees and buffers**",
    "core.table.Table.tree_unflatten": f"{DO_NOT_PORT}: **JAX pytrees and buffers**",
    "frame.series.Series.to_jax": f"{DO_NOT_PORT}: **JAX pytrees and buffers**",
    "utils.config[join.kernel_interpret]": f"{DO_NOT_PORT}: **Pallas interpret mode**",
    "utils.config[groupby.kernel_interpret]": f"{DO_NOT_PORT}: **Pallas interpret mode**",
    # host seconds by range, replaced by the spans
    "utils.tracing.Tracer.summary": "`cudf_tpu_torch.utils.tracing.Tracer.by_name` counts the "
                                    "recorded spans and sums their ms by name",
    # parameters the port names as pandas does
    "frame.accessors.DatetimeProperties.strftime(fmt)":
        f"{PANDAS_NAME} date_format: "
        "`cudf_tpu_torch.frame.accessors.DatetimeProperties.strftime`",
    "frame.accessors.StructMethods.field(name)":
        f"{PANDAS_NAME} name_or_index: `cudf_tpu_torch.frame.accessors.StructMethods.field`",
    "frame.dataframe.DataFrame.insert(name)":
        f"{PANDAS_NAME} column: `cudf_tpu_torch.frame.dataframe.DataFrame.insert`",
    "frame.index.Index.astype(dtype_)":
        f"{PANDAS_NAME} dtype: `cudf_tpu_torch.frame.index.Index.astype`",
    "frame.index.RangeIndex.astype(dtype_)":
        f"{PANDAS_NAME} dtype: `cudf_tpu_torch.frame.index.RangeIndex.astype`",
    "frame.index.MultiIndex.astype(dtype_)":
        f"{PANDAS_NAME} dtype: `cudf_tpu_torch.frame.index.MultiIndex.astype`",
    # the IO tiers' internals, folded into other stages
    "io.json_device.read_json_records_device":
        "`cudf_tpu_torch.io.json_device.read_json_device` (records=True)",
    "io.json_device.read_json_lines_device":
        "`cudf_tpu_torch.io.json_device.read_json_device` (records=False)",
    "io.orc_native.decode_bool_rle": "`cudf_tpu_torch.io.orc_native.expand_bits` over the "
                                     "runs `cudf_tpu_torch.io._native.orc_byte_rle_runs` walks",
    "io.orc_native.decode_byte_rle": "`cudf_tpu_torch.io.orc_native.expand_bytes` over the "
                                     "runs `cudf_tpu_torch.io._native.orc_byte_rle_runs` walks",
    "io.orc_native.decode_int_rle1": "`cudf_tpu_torch.io._native.orc_rle1_decode` in C",
    "io.orc_native.decode_int_rle2": "`cudf_tpu_torch.io.orc_native.expand_ints` over the "
                                     "runs `cudf_tpu_torch.io._native.orc_rle2_runs` walks",
    "io.orc_writer.write_orc_native(df)":
        "`cudf_tpu_torch.io.orc_writer.write_orc_native` takes the frame's Table "
        "(`cudf_tpu_torch.io.orc.write_orc` passes df._table)",
    "io.parquet_writer.write_parquet_native(df)":
        "`cudf_tpu_torch.io.parquet_writer.write_parquet_native` takes the frame's Table "
        "(`cudf_tpu_torch.io.parquet.write_parquet` passes df._table)",
    "io.parquet_device.parse_rle_runs": "`cudf_tpu_torch.io._native.rle_runs` walks the run "
                                        "headers in C",
    "io.parquet_native.read_column_chunk": "`cudf_tpu_torch.io.parquet_native._decode_chunk` "
                                           "over a chunk its host stage read",
    "io.parquet_native.read_column_chunk_pruned(path)":
        "`cudf_tpu_torch.io.parquet_native.read_column_chunk_pruned` reads from the open file",
    "io.parquet_native.read_column_chunk_pruned(nullable)":
        "`cudf_tpu_torch.io.parquet_native.read_column_chunk_pruned` reads it from the schema "
        "element",
    "io.parquet_native.read_column_chunk_pruned(type_length)":
        "`cudf_tpu_torch.io.parquet_native.read_column_chunk_pruned` reads it from the schema "
        "element",
    "io.parquet_nested.FieldInfo": "`cudf_tpu_torch.io.parquet_nested.LeafInfo`",
    "io.parquet_nested.schema_fields": "`cudf_tpu_torch.io.parquet_nested.schema_tree`",
    "io.parquet_nested.assemble_list": "`cudf_tpu_torch.io.parquet_nested.assemble_node`",
    "io.parquet_nested.assemble_struct": "`cudf_tpu_torch.io.parquet_nested.assemble_node`",
    "io.parquet_nested.read_chunk_levels(path)":
        "`cudf_tpu_torch.io.parquet_nested.read_chunk_levels` reads from the open file",
    "io.parquet_pushdown.sbbf_insert_hashes": "`cudf_tpu_torch.io._native.sbbf_insert`",
    # the kernels: the same contracts without the TPU's layouts
    "kernels.hash_aggregate.onehot_groupby_aggregate(interpret)":
        f"{DO_NOT_PORT}: **Pallas interpret mode**",
    "kernels.hash_aggregate.onehot_groupby_aggregate(int_mode)":
        f"{DO_NOT_PORT}: **TPU-exactness workarounds in the kernels**",
    "kernels.hash_aggregate.reference_groupby_aggregate":
        "`cudf_tpu_torch.kernels.hash_aggregate.onehot_groupby_aggregate_plain`",
    "kernels.radix_partition.partition_layout": f"{DO_NOT_PORT}: **The TPU layouts of the "
                                                "radix kernels**",
    "kernels.radix_partition.zero_empty_windows": f"{DO_NOT_PORT}: **The TPU layouts of the "
                                                  "radix kernels**",
    "kernels.radix_partition.combine_acc": f"{DO_NOT_PORT}: **TPU-exactness workarounds in "
                                           "the kernels**",
    "kernels.radix_partition.probe_tables": "`cudf_tpu_torch.kernels.radix_partition."
                                            "build_join_tables`",
    "kernels.radix_partition.probe_tables_raw": f"{DO_NOT_PORT}: **The TPU layouts of the "
                                                "radix kernels**",
    "kernels.radix_partition.occupancy_step_tab": f"{DO_NOT_PORT}: **The TPU layouts of the "
                                                  "radix kernels**",
    **{f"kernels.radix_partition.{fn}({p})": f"{DO_NOT_PORT}: **The TPU layouts of the "
                                             "radix kernels**"
       for fn, ps in (("radix_partition", ("tile_rows", "chunk_rows", "align_rows")),
                      ("radix_groupby_sum_count", ("tile_rows", "chunk_rows")),
                      ("build_join_tables", ("tile_rows", "chunk_rows", "raw_acc")),
                      ("radix_join_inner_multi", ("tile_rows", "chunk_rows")),
                      ("radix_join_inner_unique", ("tile_rows", "chunk_rows")))
       for p in ps},
    **{f"kernels.radix_partition.{fn}(interpret)": f"{DO_NOT_PORT}: **Pallas interpret mode**"
       for fn in ("radix_partition", "radix_groupby_sum_count", "build_join_tables",
                  "radix_join_inner_multi", "radix_join_inner_unique")},
    "kernels.radix_partition.radix_groupby_sum_count(int_mode)":
        f"{DO_NOT_PORT}: **TPU-exactness workarounds in the kernels**",
    "kernels.radix_partition.layout_device": "`cudf_tpu_torch.kernels.radix_partition."
                                             "partition_offsets`",
    "kernels.radix_partition.step_table_device": "`cudf_tpu_torch.kernels.radix_partition."
                                                 "step_table`",
    **{f"kernels.radix_partition.{fn}({p})": f"{DO_NOT_PORT}: **The TPU layouts of the "
                                             "radix kernels**"
       for fn, ps in (("bucket_aggregate", ("pdata", "step_tab", "shift")),
                      ("digit_histogram", ("data", "tile_rows")),
                      ("merge_scatter", ("data", "tabs", "super_rows", "tile_rows",
                                         "chunk_rows", "total_rows")),
                      ("radix_scatter", ("data", "tabs", "tile_rows", "chunk_rows",
                                         "total_rows", "mask_bits")),
                      ("window_probe", ("pdata", "step_tab", "shift", "agg_rows",
                                        "acc_planes")))
       for p in ps},
    **{f"kernels.radix_partition.{fn}(interpret)": f"{DO_NOT_PORT}: **Pallas interpret mode**"
       for fn in ("bucket_aggregate", "digit_histogram", "merge_scatter", "radix_scatter",
                  "window_probe")},
    "kernels.radix_partition.bucket_aggregate(mode)":
        "`cudf_tpu_torch.kernels.radix_partition.window_tables` is the id/idpay modes",
    # the ops: TPU lowerings the port takes PyTorch's scatters and searches for
    "ops._utils.string_payload": "`cudf_tpu_torch.core.column.Column` (offsets and data)",
    "ops._utils.searchsorted_fast": f"{DO_NOT_PORT}: **Sort-method searchsorted**",
    "ops._utils.merge_join_ranges": f"{DO_NOT_PORT}: **Sort-method searchsorted** "
                                    "(`cudf_tpu_torch.ops.join._probe_ranges`)",
    "ops._utils.expand_rows": f"{DO_NOT_PORT}: **Scatter-free run reductions and the "
                              "sort-based `inverse_permutation`** "
                              "(`cudf_tpu_torch.ops._utils.segment_expand`)",
    "ops._utils.unique_key_join": f"{DO_NOT_PORT}: **Sort-method searchsorted** "
                                  "(`cudf_tpu_torch.ops.join._probe_ranges`)",
    "ops.groupby.make_grouper(sort)": "`cudf_tpu_torch.ops.groupby.make_grouper` always "
                                      "numbers groups in key order; "
                                      "`cudf_tpu_torch.frame.groupby` orders by first "
                                      "appearance for sort=False",
    "ops.regex_engine.compile_spans_dfa": "`cudf_tpu_torch.ops.regex_engine.compile_dfa` "
                                          "(search=False)",
    "ops.regex_engine.match_spans(max_matches)":
        "`cudf_tpu_torch.ops.string_spans.select_greedy` takes max_matches",
    "ops.regex_engine.match_spans(chunk_elems)":
        "`cudf_tpu_torch.ops.regex_engine.match_spans` takes chunk (bytes a step)",
    "ops.row_ops.lex_sort_indices(stable)": "`cudf_tpu_torch.ops.row_ops.lex_sort_indices` is "
                                            "always stable (a chain of stable argsorts)",
    "ops.sort.sorted_order(stable)": "`cudf_tpu_torch.ops.sort.sorted_order` is always stable",
    "ops.search.lex_sort_indices_raw": "`cudf_tpu_torch.ops.row_ops.lex_sort_permutation`",
    "ops.string_spans.literal_match_matrix": f"{DO_NOT_PORT}: **The padded character "
                                             "matrices of the span engine** "
                                             "(`cudf_tpu_torch.ops.string_spans.literal_spans`)",
    "ops.string_spans.split_device": f"{DO_NOT_PORT}: **The padded character matrices of the "
                                     "span engine** "
                                     "(`cudf_tpu_torch.ops.string_spans.split_columns`)",
    "ops.string_spans.select_greedy(matchlen)": f"{DO_NOT_PORT}: **The padded character "
                                                "matrices of the span engine**",
    "ops.string_spans.select_greedy(lens)": f"{DO_NOT_PORT}: **The padded character matrices "
                                            "of the span engine**",
    "ops.string_spans.assemble_replace(sel_flat)": "`cudf_tpu_torch.ops.string_spans."
                                                   "assemble_replace` takes sel",
    "ops.string_spans.assemble_replace(covered_flat)": "`cudf_tpu_torch.ops.string_spans."
                                                       "assemble_replace` takes covered",
    "ops.unicode_case.encode_utf8(char_row)": "`cudf_tpu_torch.ops.unicode_case.encode_utf8` "
                                              "takes row",
    # several ranks: one process a card over torch.distributed
    "parallel.bootstrap.initialize(coordinator_address)":
        "`cudf_tpu_torch.parallel.bootstrap.initialize` takes init_method",
    "parallel.bootstrap.initialize(num_processes)":
        "`cudf_tpu_torch.parallel.bootstrap.initialize` takes world_size",
    "parallel.bootstrap.initialize(process_id)":
        "`cudf_tpu_torch.parallel.bootstrap.initialize` takes rank",
    "parallel.bootstrap.initialize(local_device_ids)":
        "`cudf_tpu_torch.parallel.bootstrap.initialize` takes local_rank",
    **{f"parallel.dist.{fn}": f"{DO_NOT_PORT}: **The fixed-size padded helpers of "
                              "`parallel/dist.py`**"
       for fn in ("pack_valid", "local_groupby_sum", "local_groupby_sum_multi",
                  "local_groupby_agg_multi", "dist_groupby_agg_shard", "local_join_padded",
                  "local_join_full_padded", "local_semi_mask", "local_over_shard")},
    **{f"parallel.{mod}.{fn}({p})": f"{DO_NOT_PORT}: **The static shapes and axis names of "
                                    "the parallel ops**"
       for mod, fn, ps in (
           ("dist", "dist_groupby_sum", ("capacity_per_bucket", "axis")),
           ("dist", "dist_groupby_sum_multi", ("capacity_per_bucket", "axis")),
           ("dist", "dist_groupby_sum_multislice", ("capacity_per_bucket",)),
           ("dist", "dist_join", ("max_out_per_shard", "axis")),
           ("dist", "dist_inner_join", ("max_out_per_shard", "axis")),
           ("dist", "broadcast_inner_join", ("max_out_per_shard", "axis")),
           ("dist", "dist_sort", ("capacity_factor", "axis")),
           ("dist", "dist_distinct", ("capacity_per_bucket", "axis")),
           ("dist", "dist_tdigest", ("axis",)),
           ("dist", "dist_quantile", ("axis",)),
           ("mesh", "partition_frame", ("axis",)),
           ("shuffle", "bucketize", ("capacity",)),
           ("shuffle", "received_mask", ("out_counts", "capacity")),
           ("shuffle", "shuffle_by_key", ("num_parts", "capacity")),
           ("shuffle", "shuffle_by_keys", ("num_parts", "capacity")),
           ("shuffle", "shuffle_by_keys_2d", ("n_dcn", "n_ici", "cap_ici", "cap_dcn")))
       for p in ps},
    "parallel.mesh.collect_frame(arrays)": "`cudf_tpu_torch.parallel.mesh.collect_frame` takes "
                                           "the rank's frame (part)",
    "parallel.mesh.collect_frame(valid)": "`cudf_tpu_torch.parallel.mesh.collect_frame` takes "
                                          "the rank's frame (part), its masks in its columns",
    "parallel.mesh.collect_frame(names)": "`cudf_tpu_torch.parallel.mesh.collect_frame` takes "
                                          "the rank's frame (part), its names with it",
    "parallel.shuffle.bucketize(arrays)": "`cudf_tpu_torch.parallel.shuffle.bucketize` takes "
                                          "a Table",
    "parallel.shuffle.bucketize(valid)": "`cudf_tpu_torch.parallel.shuffle.bucketize` takes "
                                         "a Table, its masks in its columns",
    "parallel.shuffle.exchange(bufs)": "`cudf_tpu_torch.parallel.shuffle.exchange` takes a "
                                       "Table",
    "parallel.shuffle.exchange(counts)": "`cudf_tpu_torch.parallel.shuffle.exchange` takes "
                                         "the buckets' offsets",
}
# the readers and writers of io/*; the top level, frame/*, engine/* and
# pandas/* are user-facing whole
USER_FACING_MODULES = ("io", "io.csv", "io.json", "io.parquet", "io.orc", "io.avro",
                       "io.feather", "io.tpudf_file", "io.text")
ALLOWED_USER_FACING = ("to_jax", "from_jnp", "tree_flatten", "tree_unflatten",
                       "kernel_interpret")


def _module_names(path, prefix=""):
    """The dotted names of a package's modules under ``path``, found
    without importing them (``__main__`` excluded: importing it runs it)."""
    out = []
    for info in pkgutil.iter_modules([str(path)]):
        name = prefix + info.name
        if info.name == "__main__":
            continue
        out.append(name)
        if info.ispkg:
            out += _module_names(Path(path) / info.name, name + ".")
    return out


REFERENCE_MODULES = [""] + _module_names(Path(cudf_tpu.__file__).parent)


def _qualified(pkg, rel):
    return pkg + ("." + rel if rel else "")


def _public(mod):
    """(name, defined here) for a module's public functions and classes
    (jitted and cached functions count as functions)."""
    if hasattr(mod, "__all__"):
        return [(n, getattr(getattr(mod, n), "__module__", None) == mod.__name__)
                for n in mod.__all__]
    return [(n, True) for n, v in vars(mod).items()
            if not n.startswith("_") and callable(v) and not isinstance(v, types.ModuleType)
            and getattr(v, "__module__", None) == mod.__name__]


def _params(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _import(name):
    """The module; the accelerators' pytest plugins install their proxy as
    ``pandas`` when imported, so each is uninstalled again at once, before
    any other test of the process sees it."""
    module = importlib.import_module(name)
    if name.endswith(".pandas._pytest_plugin"):
        importlib.import_module(name[:-len("._pytest_plugin")]).uninstall()
    return module


def _gaps(rel):
    """The reference module ``rel``'s names, attributes, parameters and
    options that its counterpart lacks, as qualified names."""
    ref = _import(_qualified("cudf_tpu", rel))
    try:
        port = _import(_qualified("cudf_tpu_torch", rel))
    except ModuleNotFoundError:
        return [rel]
    prefix = rel + "." if rel else ""
    gaps = []
    for name, here in _public(ref):
        if not hasattr(port, name):
            gaps.append(prefix + name)
            continue
        if not here:
            continue                       # checked in its own module
        rv, pv = getattr(ref, name), getattr(port, name)
        if isinstance(rv, type):
            for attr in dir(rv):
                if attr.startswith("_"):
                    continue
                if not hasattr(pv, attr):
                    gaps.append(f"{prefix}{name}.{attr}")
                    continue
                ra, pa = getattr(rv, attr), getattr(pv, attr)
                if callable(ra) and callable(pa):
                    gaps += [f"{prefix}{name}.{attr}({p})" for p in _missing(ra, pa)]
        elif callable(rv) and callable(pv):
            gaps += [f"{prefix}{name}({p})" for p in _missing(rv, pv)]
    if rel == "utils.config":
        gaps += [f"utils.config[{o}]" for o in ref._registry if o not in port._registry]
    return gaps


def _missing(ref_fn, port_fn):
    rp, pp = _params(ref_fn), _params(port_fn)
    if rp is None or pp is None:
        return []
    return [p for p in rp if p not in pp]


@pytest.mark.parametrize("rel", REFERENCE_MODULES, ids=lambda r: r or "cudf_tpu")
def test_the_port_has_the_reference_modules_surface(rel):
    gaps = [g for g in _gaps(rel) if g not in EXEMPT]
    assert not gaps, f"cudf_tpu_torch lacks, against {_qualified('cudf_tpu', rel)}: {gaps}"


def test_the_reference_main_modules_have_counterparts():
    """``python -m`` entry points, which the walk leaves out because
    importing one runs it."""
    mains = [p.relative_to(ROOT / "cudf_tpu").parent for p in
             (ROOT / "cudf_tpu").rglob("__main__.py")]
    assert mains
    for rel in mains:
        assert (ROOT / "cudf_tpu_torch" / rel / "__main__.py").exists(), rel


def test_every_exemption_is_still_needed():
    found = {g for rel in REFERENCE_MODULES for g in _gaps(rel)}
    assert sorted(set(EXEMPT) - found) == []


def _user_facing(key):
    """Whether an exemption's key names part of the user-facing surface:
    a user-facing module's, or a class the top level exports."""
    if key.startswith("utils.config["):
        return False
    parts = key.split("(")[0].split(".")
    modules = set(REFERENCE_MODULES)
    rel = max((".".join(parts[:i]) for i in range(len(parts) + 1)
               if ".".join(parts[:i]) in modules), key=len)
    exported = {getattr(cudf_tpu, n) for n in cudf_tpu.__all__}
    for cls in (c for c in exported if isinstance(c, type)):
        if key.startswith(f"{cls.__module__[len('cudf_tpu.'):]}.{cls.__name__}."):
            return True
    return rel == "" or rel.split(".")[0] in ("frame", "engine", "pandas") \
        or rel in USER_FACING_MODULES


def test_user_facing_modules_take_only_the_allowed_exemptions():
    for key, why in EXEMPT.items():
        if not _user_facing(key):
            continue
        allowed = any(a in key for a in ALLOWED_USER_FACING) or (
            key.endswith(")") and why.startswith(PANDAS_NAME))
        assert allowed, (key, why)


def test_every_reason_names_a_counterpart_or_a_do_not_port_line():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    do_not_port = roadmap[roadmap.index("### Do not port"):]
    for key, why in EXEMPT.items():
        titles = re.findall(r"\*\*(.+?)\*\*", why)
        names = re.findall(r"`(cudf_tpu_torch[\w.]*)`", why)
        assert titles or names, (key, why)
        for title in titles:
            assert why.startswith(DO_NOT_PORT) and f"**{title}**" in do_not_port, (key, title)
        for name in names:
            parts = name.split(".")
            for i in range(len(parts), 0, -1):
                try:
                    obj = _import(".".join(parts[:i]))
                except ModuleNotFoundError:
                    continue
                for attr in parts[i:]:
                    obj = getattr(obj, attr)
                break
            else:
                raise AssertionError((key, name))


def test_the_options_of_the_reference_are_registered():
    """Every option but ``*.kernel_interpret``, with the reference's
    default where the port has the route it chooses."""
    from cudf_tpu.utils import config as ref_config

    from cudf_tpu_torch.utils import config

    assert set(ref_config._registry) - set(config._registry) == {
        "join.kernel_interpret", "groupby.kernel_interpret"}
    # the port's kernel tiers serve every row count; it has no host page decoder
    other_default = {"groupby.fast_path_min_rows", "io.parquet.device_decode"}
    for name, opt in ref_config._registry.items():
        if name in config._registry and name not in other_default:
            assert config._registry[name].default == opt.default, name
