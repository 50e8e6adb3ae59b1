#!/usr/bin/env python3
"""Drive cudf_tpu_torch's main paths once on one CUDA card, and check them.

Run from the repository root:  python3 chip_smoke.py

With --beside DIR it only builds the kernels and times kernels A, D, B and
C at their main shapes (B and C at G1 K = 1e6 and the J1 big probe)
beside those of the checkout in DIR (e.g. the parent, unpacked by git
archive into build/parent), in one process on the same data, and prints
the times as its last line.

Phases (any failure raises; the exit code is then non-zero and no
result line is printed):

1. device: a CUDA device must be present; print its name and power limit.
2. build: compile the CUDA kernels from cudf_tpu_torch/csrc (one nvcc per
   source, all started together, sm_90a).

The G1 groupby (data G1_1e8_1e2_0_0 of h2oai db-benchmark's
groupby-datagen.R: id1 and id2 over "id001".."id100" and id3 over
"id0000000001".."id0001000000" as DICTIONARY32 categories, id4 and id5
in 1..100, id6 in 1..1e6, v1 in 1..5, v2 in 1..15, v3 uniform in
[0, 100)), 1e8 rows made on the card from seeded torch.Generators (id5,
and id1-id3, from generators of their own, so every other column keeps
its values):

3. kernels: each kernel (A onehot_groupby_aggregate, B digit_histogram,
   C radix_scatter, F tile_sort_data, G merge_scatter, D
   bucket_aggregate) against its plain PyTorch version on the card, at
   the main path's shapes: 1e8 rows, K = 100 for A and K = 1e6 for the
   rest (7-bit digits; B and C at choose_tile's 4096-key tiles, B also
   at the sorted route's 16384; F and G with 4096-key tiles, 16384-key
   supertiles, under mask_bits = 20 as the route calls them, and F once
   more without a mask: the full 32-bit order of the contract and of
   E).  A at bench K = 100's one f64 column, and q4's v1, v2, v3 in one
   launch (also timed as one launch a column).  D at q5's v1, v2, v3 in
   one launch over radix_partition's sorted route (also timed as one
   launch a column, and with one step a window: the cost of the
   cross-block combine), over that route with one f64 column, and over
   kernel C's unsorted output with one f64 column; D's outputs are
   checked after the caching allocator was filled with junk, since it
   writes every slot itself.  Tolerances: counts, histograms and integer
   sums exact; float64 sums rtol 1e-12 (atomic order varies); C, F and G
   bit for bit (C is a stable scatter: its valid rows are its plain
   version's, over junk).  Then radix_partition's two routes,
   merge_tiles = 1 (B, C) and 4 (B, F, G), must give the same windows;
   both are timed, and the B and C launches of one call of each are
   recorded.
4. main path: DataFrame.groupby().agg: q4 (mean of v1, v2, v3 by id4, the
   one-hot tier), q5 (sum of v1, v2, v3 by id6, the radix tier) and
   bench.py's {"v": ["sum", "mean", "count"]} request on v3 by id4
   (K = 100) and by id6 (K = 1e6).  Each result is checked against a
   plain PyTorch groupby on the card, and kernels A, B, F, G and D must
   each have been launched during this run.  Each query is then run
   alone with every count at 0 before it: q4 must launch A once and q5 D
   once.  Then the sum of six value columns by id6 (more than one
   partition launch carries) is checked the same way.  Then the sort
   tier, in the forms of db-benchmark's pandas solution
   (pandas/groupby-pandas.py): q6, the median and std of v3 by id4, id5
   (as_index=False, sort=False, dropna=False), and q8, the two largest v3
   of each id6 (sort_values, then groupby(...).head(2)), each run alone
   with every count at 0 before it (they must launch none of A-H), each
   against a plain PyTorch version written apart from the port (groups,
   their order and medians exact, std rtol 1e-12; q8's rows, values and
   index labels exact).  q6 runs again on a 1e7-row frame with 5% nulls
   in id4, id5 and v3 (G1_1e7_1e2_5_0's shape; a null group for each
   key), and once more under torch.profiler at 1e8 rows: device ms by
   kind of kernel (sort, gather, reduce), the host's ms in synchronising
   calls and the device's busy share of the wall time.  id5 (1..100)
   comes from a generator of its own, so the other columns keep their
   values.
5. timings: median of 7 warm runs of each query and of its plain PyTorch
   counterpart (CUDA events, then synchronize), as rows/s; q6 and q8 too.
4. the ten questions (``models/g1.py``, the pandas solution's
   ``groupby(..., as_index=False, sort=False, observed=True,
   dropna=False)``; q7 with its ``assign``, q8 with its ``isna`` filter,
   q9 the (v1, v2) cell of the grouped ``corr``, squared), all ten with
   every count at 0 before (A, B, F, G and D must each launch), each
   answer against ``plain_g1`` (codes, groups by first appearance,
   bincount / index_add_ / scatter_reduce_; q9 in two passes; q10 over two
   packed int64 keys with a stable sort): keys, group order, counts and
   integer sums exact, float sums rtol 1e-12, means and r2 rtol 1e-9.
   Each alone, every count at 0 before it, must launch exactly
   ``G1_NEEDS``' kernels (q1, q4 A; q3, q5, q7 B, F, G, D; the rest
   none), and every call of them is recorded and replayed against its
   plain version.  q9's apply form (a host loop over 1e4 groups) at 1e7
   rows must equal its corr form (one timed run); torch.profiler splits of
   q2 and q10.  Then the groupby API (``api_cases``): a SeriesGroupBy sum
   (A), ``transform("mean")`` by id4 (A) and id6 (B, F, G, D), ``corr``,
   ``cov``, ``describe``, ``rank``, ``ngroup``, ``filter``, ``ewm`` (at
   1e7) and the ops aggregations sum_of_squares, m2 and bitwise_or by
   id4, id5, each alone with its launches checked and its kernel calls
   replayed, against a plain PyTorch version.
5. timings of each question and API call beside its plain version.

The G1 frame is then freed.  The J1 inner join (data J1_1e8_NA_0_0 of
h2oai db-benchmark's join-datagen.R: a fact table of 1e8 rows, id int32
and v1 float64; dim tables of 1e2 (small), 1e5 (medium) and 1e8 (big)
rows, id a random permutation of 1..n and v2 float64; fact ids uniform
over 1..ceil(1.1 n), so about 9% of fact rows find no match), made on the
card from the same generator:

3. kernels, all checked exactly against their plain versions: kernel D's
   id and idpay modes in one launch (window_tables, float64 payload) and
   its id mode alone (the J1 path's) over J1 big's build (1e8 unique
   keys, 16384 windows, a quarter of them empty), over junk; B and C
   (bit for bit) over J1 big's probe partition at the scatter route's
   2^14 digits (B with each tile cut over blocks by tile_parts, C as two
   stable 7-bit passes), and B at the sorted route's three J1
   shapes (both J1 big passes, the J1 medium pass); E tile_sort of the
   probe keys with one int32 rider; F and
   G in both passes of the sorted route over the probe side (mask_bits
   27, then 20), and both routes of radix_partition there, which must
   give the same windows; F and G in the single pass of J1 medium's
   probe partition (2^4 digits, mask_bits 17, one int32 payload), the
   shape of three of the five merges; H window_probe at the five shapes
   the J1 path gives it: small (one window), medium and big with one
   table, big with the f64 payload (whose bits must be copied), and
   medium with three stacked tables (each key 1-3 times), and at a
   sparse probe (1e6 rows against J1 big's table), each checked after
   the caching allocator was filled with junk, and timed also with every
   window staged in shared memory and with none.
4. main path: DataFrame.merge(on="id"): q1 small, q2 medium and q5 big
   (the unique tier; small in one window, medium and big partitioned),
   the medium dim with each key 1-3 times (the stacked-table tier,
   m = 3), and dim.merge(fact) at medium (the build on the left).  Each
   result must equal a plain PyTorch join on the card (a dense table for
   a unique build, a stable sort + searchsorted + repeat_interleave
   otherwise): row order, key, v1 and v2.  Kernels B, F, G, D and H must
   each have been launched during this run, with a second pass of the
   sorted route among them (q5 big's 2^27-key domain).
5. timings: median of 7 warm runs of each merge and of models.j1_join
   (gather maps only) at small, medium and big, beside plain PyTorch, as
   probe rows/s.

Then the sort-merge tier at J1 scale (no kernel of A-H may launch):
4. main path: fact.merge(dim, on="id", how="left") at medium and big,
   ops/join.py full_join at medium and semi_join and anti_join at big,
   each equal to plain PyTorch (a dense table over the unique dim keys:
   every left row in order, v2 null where no dim row matches; the full
   join's unmatched dim rows at the end), row order included.
5. timings of each beside plain PyTorch.

The J1 frames are then freed, but for v1.  J1's dictionary-string key in
bench.py's bench_join_dict shape: 1e8 fact rows of codes over 1e5
strings, a dim of 1e5 rows whose dictionary is a permutation of the same
strings (each key once):
4. main path: fact.merge(dim, on="key"): the dim's codes recoded into
   the fact's code space (ops/join.py _dict_code_pair), then the radix
   tier (B, F, G, D and H must launch); equal to plain PyTorch (the dim
   keys' fact codes from a host dictionary, a dense table over the
   codes): key codes, v1, v2 and row order exact.
5. timing beside plain PyTorch.

TPC-H through the LazyFrame engine
(``cudf_tpu_torch/models/tpch.py``): SF10 (6e7 lineitem rows, 1.5e7
orders, 2e6 parts; ~5.3 GB on the card), then SF1 as a smaller second
run, drawn on the card by ``generate_device`` from one seeded
torch.Generator (int32 keys, dictionary codes over host key sets,
datetime64[ns] dates):

4. main path: the nine queries of benchmarks/tpch.py: q1 (temporal
   filter, arithmetic, groupby on two dictionary keys through the sort
   tier, sort), q6 (five predicates, a product, a sum), q12 (is_in on a
   dictionary, a join against the 1.5e7 unique order keys on the radix
   tier, a CASE count by one dictionary key on the one-hot tier), q14 (a
   join against the 2e6 part keys, a dictionary compared with a string),
   q3 (customer, orders and lineitem joins, revenue by two keys on the
   sort tier, top 10), q4 (a semi join against the late lineitems on the
   sort-merge tier, counts by priority), q5 (five joins, the last on two
   keys on the sort-merge tier), q9 (green parts through lineitem,
   supplier, nation and orders) and q10 (customer, orders, lineitem and
   nation, revenue by four keys on the sort tier, top 20), all with every
   count at 0 before (kernels A, B, F, G, D and H must each have been
   launched), each against its plain PyTorch version on the same
   tensors (``tpch.PLAIN``: masks, dense lookup tables, bincounts,
   index_add_): keys, counts and row order exact, float sums rtol 1e-9.
   Each query then runs alone with every count at 0 before it and must
   launch exactly the kernels ``TPCH_NEEDS`` names.  Every call of those
   kernels in that run is recorded with a copy of its arguments
   (``KernelRecorder``) and replayed on the same inputs against its
   plain version: bit for bit (A's and D's float sums rtol 1e-12; G in
   the rows its runs cover), each with its time and its plain version's.
   Then torch.profiler splits of q1, q3 and q9 at SF10, and the times of q3's
   failed multi-tier attempt against lineitem, of q4's semi join and of
   the sort of its late keys, on the queries' own inputs.
5. timings: median of 7 warm runs of each query and of its plain
   version, as lineitem rows/s, at SF10 and SF1.

TPC-H in pandas' API, on the same SF10 tables (the slice's main path):
4. main path: the nine ``tpch.FRAME_QUERIES`` (pandas_reference's bodies
   over the port's DataFrames: masks, ``__setitem__``, ``assign``,
   ``isin``, ``merge``, named ``groupby().agg``, ``sort_values``,
   ``head``, ``Series.sum``), all with every count at 0 before (A, B,
   F, G, D and H must each have been launched); each answer equal to
   its LazyFrame query's and to the plain version's (keys, counts and
   order exact, float sums rtol 1e-9); each query alone, every count at
   0 before it, must launch exactly the kernels ``TPCH_NEEDS`` names,
   and every call of them is recorded and replayed against its plain
   version as in the LazyFrame phase (the frame forms join in another
   order, so the kernels see other shapes: ``tpch_frame_calls`` in each
   kernel's row); torch.profiler splits of q1 and q3.
5. timings: each query beside its LazyFrame form and plain version.
Then ``agg().over(keys)`` over the 6e7-row lineitem: the mean quantity
over l_partkey (TPC-H q17's window, 2e6 partitions) and the extended
price summed over l_returnflag, l_linestatus, each against a plain
index_add_ / bincount and gather (rtol 1e-9), and timed.

The column primitives under the pandas API at G1_1e8_1e2_5_0's shape
(groupby-datagen.R with 5% NA: 1e8 rows of id4, id6, v1 and v3, each
null in 5% of rows): fillna, ffill, bfill, dropna, isna().sum(), cumsum,
cummax, shift, diff, clip, where, isin, astype, replace, value_counts,
nunique, astype("category") and a Series sum over one index and over two
filtered indexes, each against a plain PyTorch expression on the card
(exact; float scans rtol 1e-9) and timed; ops.scan.ewm_mean at 1e7 rows
against the same call on the CPU.

The frame API (``cudf_tpu_torch/models/frame_api.py``: ``REQUESTS``,
``PLAIN``, ``NEEDS``), in three parts, each a main path of its own (every
count at 0 before it, its kernels each launched in it):
4. over G1 at 1e8 rows, after its groupby API: ``concat`` of the two
   halves (which must equal the table) then q1 (A), ``pivot_table`` of v1
   by id1 (A), of v1 and v3 by id6 (B, F, G, D) and the mean of v3 by
   id4 x id5 (a 100 x 100 grid, the sort tier), ``crosstab(id4, id5)``,
   ``melt`` of id6, v1, v2, v3 (3e8 rows), ``get_dummies`` of id1's first
   1e7 rows (100 columns), ``cut(v3, 10)``, ``qcut(v3, 4)``, the vmapped
   UDFs ``v3.apply`` and a row ``apply(axis=1, engine="torch")`` over v1,
   v2, v3, ``id4.map`` of a dict, and ``map`` of a callable over 1e5 rows
   (a host loop); after the J1 sort-merge phase, J1 in pandas' ``join``
   form: ``fact.join(dim.set_index("id"), on="id", how="inner")`` at
   small, medium and big (each launching what the same ``merge``
   launches), ``how="left"`` at big and the index join at medium; after
   the primitives, over G1's 5%-null columns: a ``masked=True`` UDF,
   ``interpolate``, ``combine_first``, ``update`` by 1e6 labels,
   ``dropna(axis=1)``, ``quantile`` of three q and ``agg("max", axis=1)``.
   Each answer against its plain PyTorch version (keys, order, counts and
   codes exact; sums rtol 1e-12, means 1e-9); each request alone, every
   count at 0 before it, launching exactly its ``NEEDS`` (each kernel call
   recorded and replayed against its plain version: ``frame_api_calls``
   in the kernels line), each UDF taking its route (``UDF_ROUTES``: vmap,
   or host for the callable map) and no other.
5. timings of each request beside its plain version.

Strings and temporals (``cudf_tpu_torch/models/strings_dt.py``:
``REQUESTS``, ``PLAIN``, ``NEEDS``), three main paths of their own:
4. over G1 at 1e8 rows, after the frame API's G1 part: ``id3.astype(str)``
   (1e8 rows of 12 bytes) and on it ``str.len``, ``slice(2)`` as int64
   and through ``to_numeric``, ``contains`` of a literal and of
   ``^id0+[1-9]\\d{2}$`` (the device DFA), ``startswith``, ``upper``,
   ``replace(r"0+", "-")`` (the span engine), ``split("0000", n=1,
   expand=True)``, ``id1.astype(str) + "_" + v1.astype(str)``, v3 summed
   by ``str.slice(0, 8)`` (a STRING key: the sort tier, no kernel), by
   the same as a category (101 keys: A) and by ``slice(0, 10)`` as a
   category (10 001 keys: B, F, G, D), ``cat.codes`` and
   ``cat.categories``; then the same ``str`` requests on the dictionary
   ``id3`` itself; over TPC-H SF10's lineitem (6e7 rows), after its
   ``Over`` phase: ``l_shipdate.dt`` year, month, day, dayofweek,
   quarter, dayofyear, is_month_end, ``floor("D")``, ``ceil("h")``,
   ``strftime("%Y-%m-%d")`` and ``to_datetime`` of that text, the hour
   in America/New_York (``tz_localize("UTC").dt.tz_convert``), and the
   revenue summed by ``dt.year`` (A) and by ``strftime("%Y-%m")`` as a
   category (A).  Each answer against its plain PyTorch version (text by
   bytes and offsets, integers, bools and ticks exact, sums rtol 1e-12);
   each request alone launching exactly its ``NEEDS`` (every call
   replayed: ``strings_dt_calls`` in the kernels line), with
   ``STRING_ROUTES["host"]`` unmoved across the phases, and its host
   syncs counted (``torch.cuda.set_sync_debug_mode``).
5. timings of each request beside its plain version.

LIST, STRUCT and decimal columns (``cudf_tpu_torch/models/nested.py``:
``REQUESTS``, ``PLAIN``, ``NEEDS``), two main paths of their own:
4. over G1 at 1e8 rows, after its strings phases: ``groupby("id1").v1``
   ``.agg(list)`` (100 lists holding the 1e8 values) and its ``explode``
   (the multiset of (id1, v1) pairs must be the input's),
   ``groupby("id4").v2.agg("collect_set")`` (value-ordered) and its
   ``.list.len()``, the (id4, v1) histogram exploded to
   ``.struct.field("count")`` (equal to value_counts by (id4, v1)), G1 q8
   as ``ops.groupby.group_topk(k=2)`` exploded (equal, as a multiset of
   (id6, v3) pairs, to the sort-tier q8's answer), and
   ``str.split("d")`` / ``str.findall(r"[1-9]+")`` over id3 as text with
   ``.list.len()`` and ``.list.get(-1)``; over TPC-H SF10's lineitem
   after its strings phase: ``l_extendedprice``, ``l_discount`` and
   ``l_tax`` cast to decimal64 at scale -2 (DECIMAL(15,2)), q1's
   ``disc_price`` (scale -4) and ``charge`` (scale -6) and q6's
   predicate in decimal (bit for bit the int64 arithmetic on
   round(x * 100); the rows where the float64 mask differs are counted),
   the Arrow decimal128 round trip of ``charge`` where pyarrow is
   installed, and a DECIMAL128 product of two 1e7-row columns past 2^63
   (its low limb equal to the int64 product, both limbs equal to Python
   ints on 1e4 rows).  Each request alone must launch none of A-H, take
   no host route (``STRING_ROUTES``, ``HOST_ROUTES``), and has its host
   syncs counted.
5. timings of each request beside its plain version.

Ops and windows (``cudf_tpu_torch/models/ops_windows.py``: ``REQUESTS``,
``PLAIN``, ``NEEDS``, ``ROUTE``), three main paths of their own, each
answer held against its plain version inside the path and let go:
4. over G1 at 1e8 rows, after its nested phase: ``hash_values`` of (id4,
   id6) (murmur3) and of id3's text (xxhash64), md5 of 1e5 rows (a host
   route), ``hash_partition(id6, 64)``, ``round_robin_partition(8)``,
   ``pack`` / ``unpack`` and ``contiguous_split`` into 8 (the blob against
   a plain concatenation), ``groupby("id1").v3.agg("tdigest")``,
   ``rolling(1000)`` sum, mean, std, min, max, count and a centred sum,
   ``groupby("id4").v3.rolling(100).mean()``, ``ewm(alpha=0.1)``,
   ``rolling(64).apply`` (vmapped), ``query``, ``eval``, and over ``id1 +
   " " + id2 + " " + id3`` (2.4e9 bytes) ``count_tokens``, ``tokenize``,
   ``normalize_spaces``, over its first 1e7 rows ``character_ngrams(3)``,
   ``ngrams_tokenize(2)``, ``minhash`` and the Jaccard index against id3
   reversed, and the host text functions over 1e4-1e5 rows; then both
   hashes against pure-Python murmur3 and xxhash64 on 1e4 sampled rows,
   the rolling statistics against numpy on the host on 1e4 sampled rows,
   the 100 digests' estimates at 0.01, 0.5, 0.99 within 0.5 of exact
   quantiles and 8 merged partitions against the whole column's; over J1
   big a 2^30-bit bloom filter of the dim's ids probed by the fact's: no
   false negatives, the false-positive rate beside (1 - e^(-kn/m))^k; over
   TPC-H SF10's lineitem sorted by ship date, after its nested phase:
   ``resample("D")`` sum and mean (kernel A), ``resample("h")`` over 1e6
   rows (empty bins sum to 0), ``rolling("7D")`` sum and max,
   ``merge_asof`` by supplier backward, forward and nearest within 7 days,
   the ship date as day units (``dt.year``, back to ns), ``strftime`` of
   the week directives and ``%c``, and the engine's ``Rolling``.  Each
   request alone launches exactly its ``NEEDS`` (A's calls replayed:
   ``ops_windows_calls`` in the kernels line) and takes its route (the
   host requests move only ``HOST_ROUTES``, ``apply`` only
   ``UDF_ROUTES["vmap"]``), its host syncs counted; a ``Tracer`` range
   wraps each request and its summary is printed; the host route counts
   are printed at the end.
5. timings of each device request beside its plain version; a host
   request once.

The file formats (``cudf_tpu_torch/io``, ``arrow_cdata.py``;
``models/io_paths.py`` and ``models/io_formats.py`` ``REQUESTS``,
``PLAIN``, ``NEEDS``, ``ROUTE``), files in a temporary directory removed
at the end; every request leaves ``io.IO_ROUTES["pyarrow"]`` and
``["pandas"]`` at 0:

4. TPC-H SF10, after its ops phase: lineitem (sorted by l_shipdate, as
   date-clustered warehouse files are), orders and part written with the
   port's Parquet writer (DICTIONARY32 strings, TIMESTAMP_NS dates; the
   write timed); q1, q6, q12 and q14 as LazyFrames over ``scan_parquet``
   (projection and predicate pushed into the Scan), each equal to the
   plain version of the in-memory tables (keys, counts and order exact,
   floats rtol 1e-9), q12 and q14 launching B, F, G, D and H, each call
   replayed against its plain version (``io_calls`` in the kernels
   line); q6's row groups and pages read with its l_shipdate pushdown and
   without it (the same answer); ``sink_parquet`` of q1's result, read
   back equal.
5. each query's ms from the file (wall clock, the read included: median
   of 3) beside its in-memory device ms.
4. one taxi month (1.27e7 rows in the reference bench_parquet_decode's
   eight columns, snappy, dictionary pages) written and read back bit for
   bit; the host library's build seconds.
5. the read's MB/s over the file size and rows/s (median of 7 warm reads,
   wall clock with a final synchronize), its split (footer, read,
   decompress, levels, host-to-device, device decode), the write's seconds.
4. G1_1e7_1e2_0_0 (db-benchmark's 1e7-row groupby CSV, v3 rounded to 6
   decimals) made on the card, its text built on the card and written;
   ``read_csv`` through the device tokenizer (id1-id3 as categories by
   ``dtype``, the others int32 / float64, as the pandas solution reads
   it): ints and strings exact, v3 within 1 ulp; G1 q1-q5 over the frame
   read back equal to the same questions over the frame in memory (q1, q4
   launch A; q3, q5 B, F, G, D); a LIST<int32> column (``groupby("id4")
   .v1.agg(list)``) and a STRUCT of (id4, v3) written and read back equal;
   the frame through ``__arrow_c_stream__`` and back (capsules only).
5. ``read_csv``'s ms, MB/s and host syncs; each request's ms.
4. the other formats (``models/io_formats.py``), after G1 from CSV: G1_1e7
   as NDJSON (pandas' ``to_json(lines=True)`` text built on the card,
   ~1.1 GB): ``to_json`` equal to it byte for byte, ``read_json`` (ints
   and strings exact, v3 within 1 ulp), G1 q1-q5 over the frame read
   equal to memory (q1, q4 launch A; q3, q5 B, F, G, D; each call
   replayed), the records orient at 1e6 rows; the taxi month as ORC with
   snappy and with zlib, read back bit for bit, and G1_1e7 as ORC (id1-id3
   STRING) read back and q3 over it; G1_1e7 as Avro containers (null and
   deflate, 64 Ki-row blocks) read equal and q1 over them; the tpudf file
   bit for bit; ``read_text`` of the NDJSON (every line, the first and
   last equal); a ``StreamConsumer`` over ten appends each cut
   mid-record (each poll exactly the records completed, all of them the
   frame).  Feather is not run: its only tier is pyarrow's.
5. each read's MB/s and rows/s, JSON's host syncs and peak device
   memory, each write's seconds, q1 over Avro; each group's seconds.

The partitioned executor (``engine/streaming.py``, ``utils/spill.py``;
``models/partitioned.py`` ``REQUESTS``, ``IN_MEMORY``, ``NEEDS``), three
main paths of their own, each answer held to the same plan's in-memory
``collect()`` on the same data (rows after a sort on all columns,
dictionaries decoded; integers, counts and strings exact, floats rtol
1e-9):
4. over G1 at 1e8 rows, after its ops phase: ``collect(mesh=8)`` of the
   sum, mean, count, var and std of v1-v3 by id4 (K = 100: the partial
   aggregations launch A) and by id6 (K = 1e6: B, F, G, D), every kernel
   call of each replayed against its plain version; over J1 big after its
   ops phase: ``collect(mesh=8)`` of the inner join, the dim broadcast
   (``executor.broadcast_limit`` at its bytes) and shuffled after a bloom
   filter (the limit at half its bytes), each launching B, F, G, D and H,
   the shuffle's calls replayed; over TPC-H SF10, after its IO phase: the
   seven tables written by the port's Parquet writer (lineitem and orders
   16 files each), the nine queries with ``streaming=True`` scanning the
   files, spilling off, then on under a 16 MiB budget (``spills > 0`` for
   every query with a GroupBy or Join); each run's inner joins (q3, q5,
   q9, q10, q12, q14) launch B, F, G, D and H, and q5's calls are
   replayed; one ``spill_to_budget`` over lineitem's files read back, its
   freed bytes within 5% of the drop of ``torch.cuda.memory_allocated``,
   every buffer of every column (data, validity, offsets, children)
   brought back bit for bit.
5. each request's ms (first run, wall clock; G1 and J1 also warm, median
   of 3) beside the in-memory ``collect()``'s, its partition count, spill
   statistics, ``torch.cuda.max_memory_allocated`` and launches.

The multi-rank path (``engine/spmd.py``, ``parallel/*``;
``models/distributed.py`` ``REQUESTS``, ``IN_MEMORY``, ``NEEDS``), three
main paths of their own over a mesh of one rank: NCCL at world size 1 on
this card (a ``FileStore`` in a temporary directory), the process group
destroyed before the last line.  ``nvidia-smi -L``'s card count is logged
beside ``torch.cuda.device_count()``; only the card given is used (NCCL
puts one rank on a card).  Each answer is held to the same question's
in-memory answer on the same data (rows after a sort on all columns, or in
order for the sort and the frame groupbys; floats rtol 1e-9), every plan
runs with no ``Unlowerable`` fallback, and each request must launch its
``NEEDS``:
4. over G1 at 1e8 rows after its partitioned phase: ``distributed_groupby_agg``
   of v1-v3 by id4 (A) and by id6 (B, F, G, D), the LazyFrame groupby of
   sum, mean, count, var, std by each through ``collect(mesh=make_mesh())``,
   ``dist_sort`` by (id4, id5) with v1 riding and ``dist_distinct`` of
   (id4, id5, v1); over J1 big after its partitioned phase: the inner join
   shuffled (``executor.broadcast_limit`` 0) and broadcast, each launching
   B, F, G, D and H, the shuffle's calls replayed against their plain
   versions; over TPC-H SF10 after its partitioned phase: q1, q3, q5, q6
   with ``mesh=make_mesh()`` (q3 and q5 launch B, F, G, D, H).
5. each request's wall ms beside the in-memory answer's and (for the
   plans) ``collect(mesh=8)``'s, its collective calls with the bytes and
   ms of each kind (``all_to_all_single``, ``all_gather``, ``all_reduce``:
   CUDA events), ``torch.cuda.max_memory_allocated`` and launches.

Each G row says what its timed window holds (the outputs' torch.empty,
and with out_rows G's own fill of the rows no run covers) and G's
resident blocks per SM, threads and shared memory; A's, D's, B's and
C's rows carry theirs and their registers, and B's its cut (tiles,
parts a tile, keys a part).  The G, D, A, B and C rows carry
ptxas's report on their kernels (-Xptxas -v, compiled beside the
build), and the A, D, B and C rows the shared-memory atomics (ATOMS
opcodes, counted in cuobjdump -sass) of their kernels.

Each kernel's bound is the larger of the bytes it must move (each input
read once, each output written once; for a gather, each table entry the
run's keys touch) over 3.35 TB/s and its operations over 67e12 a second,
the H100 SXM's published HBM rate and scalar float32 rate (a sort of
tiles of T keys: n log2 T comparisons; a merge of M tiles: n log2 M).
Library calls: H's m = 3 row times tables.index_select(1, idx), all
three lookups; no single call gives H's ids and payload together, so
that row has none and records torch.take of each as two_calls_ms.

Each kernel's row also carries its launches by G1 question, API call,
frame API request, IO request and partitioned request and, in
``g1_calls``, ``frame_api_calls``, ``io_calls`` and ``partitioned_calls``,
each replayed call of those.

The last three lines are the card's nvidia-smi name and power limit, a
JSON line of the kernels, and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

import argparse
import concurrent.futures
import inspect
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

N = 100_000_000
K_LOW, K_HIGH = 100, 1_000_000
J1_DIMS = {"small": 100, "medium": 100_000, "big": 100_000_000}
SEED = 20240601
REPS = 7
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*parts):
    print(*parts, flush=True)


def device_ms(fn, reps=REPS):
    """Median device time of fn() over reps warm runs, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def timed_row(err, kernel, plain, library, moved, ops, **extra):
    """A kernel's numbers: its check's error, its time, its plain
    version's and the library call's (None: no single call), and its bound
    from the bytes it must move and the operations it does."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    row = dict(max_abs_err=err, ms=device_ms(kernel),
               plain_ms=device_ms(plain),
               library_ms=None if library is None else device_ms(library),
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    row.update(extra)
    return row


def show(name, row):
    log(f"kernel {name}: max_abs_err {row['max_abs_err']} ms {row['ms']} plain_ms "
        f"{row['plain_ms']} library_ms {row['library_ms']} bound_ms {row['bound_ms']} "
        f"({row['bound_by']})")


def max_abs_err(got, exp):
    if got.numel() == 0:
        return 0.0
    return float((got.double() - exp.double()).abs().max())


def same(got, exp, what, float_rtol=1e-12, float_atol=0.0):
    """Exact for integers, rtol (and atol) for floats; returns the max abs
    error."""
    check(got.dtype == exp.dtype and got.shape == exp.shape,
          f"{what}: {got.dtype}{list(got.shape)} vs {exp.dtype}{list(exp.shape)}")
    if got.dtype.is_floating_point:
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
        check(torch.allclose(got, exp, rtol=float_rtol, atol=float_atol), f"{what}: differs")
    else:
        check(torch.equal(got, exp), f"{what}: differs")
    return max_abs_err(got, exp)


def same_bits(got, exp, what):
    """Bit for bit (NaN and -0.0 included)."""
    check(got.dtype == exp.dtype and got.shape == exp.shape
          and torch.equal(got.view(torch.uint8), exp.view(torch.uint8)), f"{what}: differs")
    return 0.0


def tile_sort_row(ts, keys, payloads, tile, mask_bits, shape):
    """Kernel F bit for bit against its plain version, and its row; the
    library call is a stable torch.sort of the keys' whole tiles."""
    sk, sp = ts.tile_sort_data(keys, payloads, tile, alternate=True, mask_bits=mask_bits)
    ek, ep = ts.tile_sort_data_plain(keys, payloads, tile, True, mask_bits)
    same_bits(sk, ek, f"F keys ({shape})")
    for got, exp in zip(sp, ep):
        same_bits(got, exp, f"F payloads ({shape})")
    del ek, ep
    n = keys.numel()
    lib = keys[:n // tile * tile].view(-1, tile)
    row = timed_row(
        0.0,
        lambda: ts.tile_sort_data(keys, payloads, tile, alternate=True, mask_bits=mask_bits),
        lambda: ts.tile_sort_data_plain(keys, payloads, tile, True, mask_bits),
        lambda: torch.sort(lib, dim=1, stable=True), 2 * nbytes(keys, *payloads),
        n * (tile.bit_length() - 1), shape=shape, mask_bits=mask_bits)
    return row, (sk, sp)


def sorted_pass(rp, ts, keys, payloads, nbits, shift, offsets, base, mask_bits, shape,
                out_rows=None):
    """Kernels F and G over one pass of the sorted route, each bit for
    bit against its plain version (G in every row it writes: base[-1],
    or out_rows); (F's row, G's row, G's output)."""
    tile, st = rp.SORT_TILE, rp.MERGE_TILES * rp.SORT_TILE
    f_row, (sk, sp) = tile_sort_row(ts, keys, payloads, tile, mask_bits, shape)
    out = rp.merge_scatter(sk, sp, offsets, nbits, shift, st, tile, mask_bits, out_rows)
    ek, ep = rp.merge_scatter_plain(sk, sp, offsets, nbits, shift, st, tile, mask_bits,
                                    out_rows)
    m = int(base[-1]) if out_rows is None else out_rows
    same_bits(out[0][:m], ek[:m], f"G keys ({shape})")
    for got, exp in zip(out[1], ep):
        same_bits(got[:m], exp[:m], f"G payloads ({shape})")
    del ek, ep
    n = keys.numel()
    g_row = timed_row(
        0.0,
        lambda: rp.merge_scatter(sk, sp, offsets, nbits, shift, st, tile, mask_bits, out_rows),
        lambda: rp.merge_scatter_plain(sk, sp, offsets, nbits, shift, st, tile, mask_bits,
                                       out_rows),
        None, 2 * nbytes(keys, *payloads) + nbytes(offsets),
        n * (rp.MERGE_TILES.bit_length() - 1), shape=shape, mask_bits=mask_bits,
        output_allocation="inside the timed window: torch.empty of the outputs"
        + ("" if out_rows is None else ", and kernel G's own fill of the rows no run covers"),
        occupancy=rp.merge_scatter_occupancy(st, nbits))
    return f_row, g_row, out


def route_phase(dev, rp, keys, vals, bits, what):
    """radix_partition at merge_tiles = 1 (kernels B, C) and 4 (B, F, G):
    the same base and, in every window, the same (key, row, value bits);
    returns both routes' times in ms and the B and C launches of one
    call of each."""
    rows = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
    outs, times, launches = {}, {}, {}
    for mt in (1, 4):
        before = rp.digit_histogram.launches, rp.radix_scatter.launches
        pk, pv, base, G = rp.radix_partition(keys, [rows] + vals, bits, merge_tiles=mt)
        launches[f"merge_tiles={mt}"] = {
            "digit_histogram": rp.digit_histogram.launches - before[0],
            "radix_scatter": rp.radix_scatter.launches - before[1]}
        m = int(base[-1])
        win = torch.repeat_interleave(torch.arange(G, device=dev), base[1:] - base[:-1])
        check(torch.equal(pk[:m].long() >> rp.WINDOW_BITS, win),
              f"{what} merge_tiles={mt}: a key outside its window")
        order = torch.argsort(pv[0][:m].long() + win * keys.numel())
        outs[mt] = [base, pk[:m][order]] + [p[:m][order] for p in pv]
        del pk, pv, win, order
        times[mt] = device_ms(lambda: rp.radix_partition(keys, vals, bits, merge_tiles=mt))
    for a, b in zip(outs[1], outs[4]):
        same_bits(a, b, f"{what}: the routes' windows")
    check(launches["merge_tiles=1"]["radix_scatter"] > 0, f"{what}: merge_tiles=1 ran no C")
    log(f"route {what}: merge_tiles=1 (B, C) {times[1]:.3f} ms, merge_tiles=4 (B, F, G) "
        f"{times[4]:.3f} ms; same windows; launches {launches}")
    return {"merge_tiles=1": times[1], "merge_tiles=4": times[4], "launches": launches}


def kernel_phase(dev, gen, ha, rp, ts):
    """Each G1 kernel against its plain version at the main path's shapes."""
    rows = {}
    codes_low = torch.randint(0, K_LOW, (N,), generator=gen, device=dev, dtype=torch.int32)
    v_int = torch.randint(1, 16, (N,), generator=gen, device=dev, dtype=torch.int32)
    v_f64 = torch.rand(N, generator=gen, device=dev, dtype=torch.float64) * 100

    v_small = torch.randint(1, 6, (N,), generator=gen, device=dev, dtype=torch.int32)
    err = 0.0
    for vals in (v_int, v_f64):
        got = ha.onehot_groupby_aggregate(codes_low, vals, K_LOW, with_minmax=False)
        exp = ha.onehot_groupby_aggregate_plain(codes_low, vals, K_LOW, with_minmax=False)
        err = max(err, same(got[0], exp[0], "A sums"), same(got[1], exp[1], "A counts"))
    rows["onehot_groupby_aggregate"] = timed_row(
        err,
        lambda: ha.onehot_groupby_aggregate(codes_low, v_f64, K_LOW, with_minmax=False),
        lambda: ha.onehot_groupby_aggregate_plain(codes_low, v_f64, K_LOW, with_minmax=False),
        lambda: torch.zeros(K_LOW, dtype=torch.float64, device=dev).index_add_(
            0, codes_low, v_f64),
        nbytes(codes_low, v_f64) + 16 * K_LOW, 2 * N,
        shape="bench K = 100: 1e8 rows, one f64 column",
        occupancy=ha.onehot_aggregate_occupancy(K_LOW, [False]))
    show("A", rows["onehot_groupby_aggregate"])
    q4 = [v_small, v_int, v_f64]                        # q4's v1, v2, v3 in one launch
    before = ha.onehot_groupby_aggregate.launches
    got = ha.onehot_groupby_aggregate(codes_low, q4, K_LOW, with_minmax=False)
    check(ha.onehot_groupby_aggregate.launches == before + 1, "A: q4's columns in one launch")
    exp = ha.onehot_groupby_aggregate_plain(codes_low, q4, K_LOW, with_minmax=False)
    err = same(got[1], exp[1], "A q4 counts")
    for a, b in zip(got[0], exp[0]):
        err = max(err, same(a, b, "A q4 sums"))
    shape = "q4: 1e8 rows, K = 100, int32 + int32 + f64 columns in one launch"
    row = timed_row(
        err, lambda: ha.onehot_groupby_aggregate(codes_low, q4, K_LOW, with_minmax=False),
        lambda: ha.onehot_groupby_aggregate_plain(codes_low, q4, K_LOW, with_minmax=False),
        None, nbytes(codes_low, *q4) + 32 * K_LOW, 4 * N, shape=shape,
        occupancy=ha.onehot_aggregate_occupancy(K_LOW, [False] * 3))
    row["one_launch_a_column_ms"] = device_ms(lambda: [ha.onehot_groupby_aggregate(
        codes_low, v, K_LOW, with_minmax=False) for v in q4])
    rows["onehot_groupby_aggregate"]["modes"] = {shape: row}
    show("A, q4's three columns in one launch", row)
    log(f"  the same columns in one launch each: {row['one_launch_a_column_ms']} ms")
    del codes_low

    codes = torch.randint(0, K_HIGH, (N,), generator=gen, device=dev, dtype=torch.int32)
    nbits = (K_HIGH - 1).bit_length() - rp.WINDOW_BITS
    tile = rp.choose_tile(N, nbits)
    shift = rp.WINDOW_BITS
    hist = rp.digit_histogram(codes, nbits, shift, tile)
    same(hist, rp.digit_histogram_plain(codes, nbits, shift, tile), "B hist")
    rows["digit_histogram"] = timed_row(
        0.0,
        lambda: rp.digit_histogram(codes, nbits, shift, tile),
        lambda: rp.digit_histogram_plain(codes, nbits, shift, tile), None,
        nbytes(codes, hist), N, shape=f"G1 K = 1e6: 1e8 keys, 2^{nbits} digits, tile {tile} "
        "(choose_tile's: the scatter route's)", cut=cut_of(rp, N, tile, nbits),
        occupancy=rp.partition_occupancy("digit_histogram", nbits))
    show(f"B (exact, tile {tile})", rows["digit_histogram"])

    offsets, base = rp.partition_offsets(hist)
    payloads = [v_int, v_f64]
    pk, pv = scatter_check(rp, codes, payloads, offsets, base, nbits, shift, tile, N, "C")
    window = torch.repeat_interleave(torch.arange(1 << nbits, device=dev),
                                     base[1:] - base[:-1])
    check(torch.equal(pk[:N].long() >> shift, window), "C: a key outside its bucket")
    del window
    rows["radix_scatter"] = timed_row(
        0.0,
        lambda: rp.radix_scatter(codes, payloads, offsets, nbits, shift, tile),
        lambda: rp.radix_scatter_plain(codes, payloads, offsets, nbits, shift, tile), None,
        2 * nbytes(codes, *payloads) + nbytes(offsets), N,
        shape=f"G1 K = 1e6: 1e8 keys, int32 + f64 payloads, 2^{nbits} buckets, tile {tile}",
        occupancy=rp.partition_occupancy("radix_scatter", nbits, 4 + 8))
    show("C (bit for bit)", rows["radix_scatter"])

    st = rp.MERGE_TILES * rp.SORT_TILE
    name = f"G1 K = 1e6: 1e8 keys, 2^{nbits} digits, tile {st} (the sorted route's supertile)"
    rows["digit_histogram"]["modes"] = {name: hist_row(rp, codes, nbits, shift, st, name)}
    offsets, base_st = rp.partition_offsets(rp.digit_histogram(codes, nbits, shift, st))
    check(torch.equal(base_st, base), "B at supertile granularity: other windows")
    shape = "G1 K = 1e6: 1e8 keys, int32 + f64 payloads, mask_bits 20 (the route's)"
    rows["tile_sort_data"], rows["merge_scatter"], _ = sorted_pass(
        rp, ts, codes, payloads, nbits, shift, offsets, base, nbits + shift, shape)
    show("F (bit for bit)", rows["tile_sort_data"])
    show("G (bit for bit)", rows["merge_scatter"])
    shape = "G1 K = 1e6 keys and payloads, no mask (the full 32-bit order, E's)"
    unmasked, _ = tile_sort_row(ts, codes, payloads, rp.SORT_TILE, None, shape)
    rows["tile_sort_data"]["modes"] = {shape: unmasked}
    show("F without a mask (bit for bit)", unmasked)
    rows["merge_scatter"]["route_ms_g1"] = route_phase(dev, rp, codes, payloads,
                                                       nbits + shift, "G1 K = 1e6")

    G = 1 << nbits
    modes = {}
    shape = "G1 K = 1e6 over kernel C's output (merge_tiles = 1; unsorted runs), one f64 column"
    err = 0.0
    for vals in pv:
        err = max(err, d_check(rp, pk, vals, base, G, "D over C's output"))
    got = rp.bucket_aggregate(pk, pv[1], base, G)
    modes[shape] = timed_row(
        err,
        lambda: rp.bucket_aggregate(pk, pv[1], base, G),
        lambda: rp.bucket_aggregate_plain(pk, pv[1], base, G),
        lambda: torch.zeros(G * rp.SPAN, dtype=torch.float64, device=dev).index_add_(
            0, pk, pv[1]),
        nbytes(pk, pv[1], *got), 2 * N, shape=shape)
    show("D over C's output, one f64 column", modes[shape])
    del pk, pv, got

    # the main path's D: q5's v1, v2, v3 through the sorted route, one launch
    q5 = [v_small, v_int, v_f64]
    pk, pv, base, G = rp.radix_partition(codes, q5, nbits + shift)
    before = rp.bucket_aggregate.launches
    err = d_check(rp, pk, pv, base, G, "D q5")
    check(rp.bucket_aggregate.launches == before + 1, "D: q5's columns in one launch")
    got = rp.bucket_aggregate(pk, pv, base, G)
    shape = "G1 K = 1e6 over the sorted route's output: q5's int32 + int32 + f64, one launch"
    row = timed_row(
        err, lambda: rp.bucket_aggregate(pk, pv, base, G),
        lambda: rp.bucket_aggregate_plain(pk, pv, base, G), None,
        nbytes(pk, *pv, *got[0], got[1]), 4 * N, shape=shape,
        occupancy=rp.bucket_aggregate_occupancy(3))
    row["three_index_add_ms"] = device_ms(lambda: [torch.zeros(
        G * rp.SPAN, dtype=torch.float64 if v.is_floating_point() else torch.int64,
        device=dev).index_add_(0, pk, v if v.is_floating_point() else v.long()) for v in pv])
    row["one_launch_a_column_ms"] = device_ms(
        lambda: [rp.bucket_aggregate(pk, v, base, G, with_counts=j == 0)
                 for j, v in enumerate(pv)])
    row["one_step_a_window_ms"] = device_ms(         # agg_rows above every window's rows
        lambda: rp.bucket_aggregate(pk, pv, base, G, agg_rows=1 << 21))
    same(rp.bucket_aggregate(pk, pv, base, G, agg_rows=1 << 21)[0][2], got[0][2],
         "D q5, one step a window")
    rows["bucket_aggregate"] = row
    show("D, q5's three columns in one launch", row)
    log(f"  three index_add_ calls {row['three_index_add_ms']} ms; one launch a column "
        f"{row['one_launch_a_column_ms']} ms; one step a window (no global atomics) "
        f"{row['one_step_a_window_ms']} ms")
    shape = "G1 K = 1e6 over the sorted route's output, one f64 column"
    modes[shape] = timed_row(
        0.0, lambda: rp.bucket_aggregate(pk, pv[2], base, G),
        lambda: rp.bucket_aggregate_plain(pk, pv[2], base, G),
        lambda: torch.zeros(G * rp.SPAN, dtype=torch.float64, device=dev).index_add_(
            0, pk, pv[2]),
        nbytes(pk, pv[2], *got[0][2:], got[1]), 2 * N, shape=shape,
        occupancy=rp.bucket_aggregate_occupancy(1))
    show("D over the sorted route, one f64 column", modes[shape])
    row["modes"] = modes
    return rows


def d_check(rp, pk, vals, base, G, what):
    """Kernel D (one column or a list) against its plain version, its
    outputs allocated over junk since it writes every slot itself; counts
    exact, integer sums exact, float sums rtol 1e-12 (atomic order)."""
    size = G * rp.SPAN
    ncols = 1 if isinstance(vals, torch.Tensor) else len(vals)
    fill_junk(*[(2 * size,)] * (ncols + 1))
    got, counts = rp.bucket_aggregate(pk, vals, base, G)
    exp, e_counts = rp.bucket_aggregate_plain(pk, vals, base, G)
    err = same(counts, e_counts, f"{what} counts")
    for a, b in zip([got] if ncols == 1 else got, [exp] if ncols == 1 else exp):
        err = max(err, same(a, b, f"{what} sums"))
    return err


def g1_frame(ct, dev, gen):
    """id5 comes from a generator of its own, drawn after the others, so
    every other column of every phase keeps the values it had before q6;
    id1, id2 and id3 from another, drawn last."""
    def ints(lo, hi, g=gen):
        return torch.randint(lo, hi + 1, (N,), generator=g, device=dev, dtype=torch.int32)

    from cudf_tpu_torch.core.column import Column

    df = ct.DataFrame({
        "id4": ints(1, K_LOW), "id6": ints(1, K_HIGH),
        "v1": ints(1, 5), "v2": ints(1, 15),
        "v3": torch.rand(N, generator=gen, device=dev, dtype=torch.float64) * 100,
        "id5": ints(1, K_LOW, torch.Generator(device=dev).manual_seed(SEED + 5)),
    })
    # groupby-datagen.R's categories: id1, id2 over "id001".."id100", id3 over
    # "id0000000001".."id0001000000", DICTIONARY32 codes over the sorted keys
    cats = torch.Generator(device=dev).manual_seed(SEED + 13)
    for name, k, width in (("id1", K_LOW, 3), ("id2", K_LOW, 3), ("id3", N // K_LOW, 10)):
        keys = Column.from_strings([f"id{i:0{width}d}" for i in range(1, k + 1)], device=dev)
        df[name] = Column.from_dictionary(
            torch.randint(0, k, (N,), generator=cats, device=dev, dtype=torch.int32), keys)
    return df


QUERIES = {
    "q4": ("id4", {"v1": "mean", "v2": "mean", "v3": "mean"}),
    "q5": ("id6", {"v1": "sum", "v2": "sum", "v3": "sum"}),
    "bench_k100": ("id4", {"v3": ["sum", "mean", "count"]}),
    "bench_k1e6": ("id6", {"v3": ["sum", "mean", "count"]}),
}


def plain_query(df, key, spec):
    """The same groupby in plain PyTorch: (group keys, {name: tensor}).
    An integer column's sums come in its own dtype when every sum fits
    it, as pandas gives them."""
    k = df._table[key].data
    lo, hi = (int(x) for x in torch.aminmax(k))
    codes = (k - lo).long()
    counts = torch.bincount(codes, minlength=hi - lo + 1)
    present = torch.nonzero(counts).squeeze(1)
    out = {}
    multi = any(isinstance(a, list) for a in spec.values())
    for col, aggs in spec.items():
        v = df._table[col].data
        acc = torch.float64 if v.dtype.is_floating_point else torch.int64
        sums = torch.zeros(hi - lo + 1, dtype=acc, device=k.device).index_add_(0, codes, v.to(acc))
        if not v.is_floating_point():        # pandas: the column's dtype when every sum fits
            info = torch.iinfo(v.dtype)
            s_lo, s_hi = (int(x) for x in torch.aminmax(sums[present]))
            if info.min <= s_lo and s_hi <= info.max:
                sums = sums.to(v.dtype)
        for agg in (aggs if isinstance(aggs, list) else [aggs]):
            res = {"sum": sums, "count": counts, "mean": sums.double() / counts}[agg]
            out[(col, agg) if multi else col] = res[present]
    return (present + lo).to(k.dtype), out


def wide_frame(ct, df):
    """id6 and six value columns: more than one scatter launch carries, so
    the radix tier must pair each column with its keys through row ids."""
    t = df._table
    v1, v2, v3 = t["v1"].data, t["v2"].data, t["v3"].data
    return ct.DataFrame({"id6": t["id6"].data, "v1": v1, "v2": v2, "v3": v3,
                         "w1": v1 * v2, "w2": v2 - 7 * v1, "w3": v3 * 0.5 + v1})


def check_query(name, res, exp):
    keys, cols = exp
    idx = res.index.column().data
    check(len(res) == keys.shape[0], f"{name}: {len(res)} groups, expected {keys.shape[0]}")
    same(idx, keys, f"{name} keys")
    check(list(res._table.names) == list(cols), f"{name}: columns {res._table.names}")
    for col, want in cols.items():
        c = res._table[col]
        check(c.validity is None or bool(c.validity.all()), f"{name} {col}: nulls")
        same(c.data, want, f"{name} {col}")


# ----------------------------------------------------------------------
# G1 q6 and q8: the sort tier
# ----------------------------------------------------------------------

def q6(df):
    """db-benchmark G1 q6 in its pandas solution's form: median and std of
    v3 by id4, id5 (``models/g1.py``)."""
    from cudf_tpu_torch.models import g1

    return g1.q6(df)


def q8(df):
    """db-benchmark G1 q8 in its pandas solution's form: the two largest v3
    of each id6."""
    return df[["id6", "v3"]].sort_values("v3", ascending=False).groupby(
        "id6", sort=False, dropna=False).head(2)


def _key_codes(col, domain):
    """(int64 codes key - 1, with a null key at ``domain``)."""
    codes = col.data.long() - 1
    return codes if col.validity is None else torch.where(col.validity, codes, domain)


def plain_q6(df):
    """q6 in plain PyTorch, written apart from the port: codes (id4 - 1) *
    width + (id5 - 1) (a null key its own code, last), groups in order of
    first appearance by scatter_reduce_("amin") of row ids, medians from a
    stable sort of v3 within codes (the midpoint of the middle two), std
    in two passes (ddof 1).  Returns {name: (data, valid)}."""
    t = df._table
    width = K_LOW + 1 if t["id4"].validity is not None or t["id5"].validity is not None \
        else K_LOW
    codes = _key_codes(t["id4"], K_LOW) * width + _key_codes(t["id5"], K_LOW)
    n, G = codes.numel(), width * width
    dev = codes.device
    first = torch.full((G,), n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, codes, torch.arange(n, device=dev), "amin")
    present = torch.nonzero(first < n).squeeze(1)
    groups = present[torch.argsort(first[present])]
    v3 = t["v3"].data
    ok = torch.ones(n, dtype=torch.bool, device=dev) if t["v3"].validity is None \
        else t["v3"].validity
    vcodes = torch.where(ok, codes, G)                 # null values: a code of their own
    cnt = torch.bincount(vcodes, minlength=G + 1)[:G]
    perm = torch.sort(v3, stable=True).indices
    perm = perm[torch.sort(vcodes[perm], stable=True).indices]
    xs = v3[perm]
    starts = torch.cumsum(cnt, 0) - cnt
    lo = (starts + (cnt - 1).clamp(min=0) // 2).clamp(max=n - 1)
    hi = (starts + cnt // 2).clamp(max=n - 1)
    median = (xs[lo] + xs[hi]) / 2
    s = torch.zeros(G, dtype=torch.float64, device=dev).index_add_(0, codes[ok], v3[ok])
    mean = s / cnt.clamp(min=1)
    d = v3[ok] - mean[codes[ok]]
    ss = torch.zeros(G, dtype=torch.float64, device=dev).index_add_(0, codes[ok], d * d)
    std = torch.sqrt(ss / (cnt - 1).clamp(min=1))
    c = cnt[groups]
    id4, id5 = groups // width, groups % width
    return {("id4", ""): ((id4 + 1).int(), id4 < K_LOW),
            ("id5", ""): ((id5 + 1).int(), id5 < K_LOW),
            ("v3", "median"): (median[groups], c > 0),
            ("v3", "std"): (std[groups], c > 1)}


def plain_q8(df):
    """q8 in plain PyTorch: a stable descending argsort of v3, ranks within
    id6 by a stable sort of the reordered id6, ranks < 2 kept in the
    sorted frame's order.  Returns (frame rows, {name: tensor})."""
    t = df._table
    perm = torch.sort(t["v3"].data, descending=True, stable=True).indices
    ids = t["id6"].data[perm]
    p2 = torch.sort(ids, stable=True).indices
    s = ids[p2]
    n = s.numel()
    pos = torch.arange(n, device=s.device)
    rank = pos - torch.searchsorted(s, s)             # each run's first position
    keep = torch.zeros(n, dtype=torch.bool, device=s.device)
    keep[p2] = rank < 2
    rows = perm[torch.nonzero(keep).squeeze(1)]
    return rows, {"id6": t["id6"].data[rows], "v3": t["v3"].data[rows]}


def check_q6(name, res, exp):
    check(list(res._table.names) == list(exp), f"{name}: columns {res._table.names}")
    n = exp[("v3", "median")][0].numel()
    check(len(res) == n, f"{name}: {len(res)} groups, expected {n}")
    err = 0.0
    for col, (want, valid) in exp.items():
        c = res._table[col]
        got_valid = c.validity if c.validity is not None else torch.ones_like(valid)
        check(torch.equal(got_valid, valid), f"{name} {col}: nulls differ")
        rtol = 1e-12 if col == ("v3", "std") else 0.0   # groups, order, medians exact
        err = max(err, same(c.data[valid], want[valid], f"{name} {col}", float_rtol=rtol))
    return err


def check_q8(name, res, exp):
    rows, cols = exp
    check(len(res) == rows.numel(), f"{name}: {len(res)} rows, expected {rows.numel()}")
    same(res.index.column().data, rows, f"{name} index labels")
    for col, want in cols.items():
        same(res._table[col].data, want, f"{name} {col}", float_rtol=0.0)
    return rows.numel()


def g1_null_frame(ct, dev, gen, n):
    """G1_1e7_1e2_5_0's shape: n rows, 5% nulls in id4, id5 and v3."""
    from cudf_tpu_torch.core import dtypes as dt
    from cudf_tpu_torch.core.column import Column

    def ints(hi):
        return torch.randint(1, hi + 1, (n,), generator=gen, device=dev, dtype=torch.int32)

    def valid():
        return torch.rand(n, generator=gen, device=dev) >= 0.05

    v3 = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) * 100
    return ct.DataFrame({"id4": Column(dt.INT32, n, ints(K_LOW), valid()),
                         "id5": Column(dt.INT32, n, ints(K_LOW), valid()),
                         "v3": Column(dt.FLOAT64, n, v3, valid())})


def profile_split(fn):
    """One warm run of fn under torch.profiler: device ms by kind of
    kernel (sort, gather, reduce, other), the host's ms and calls in
    synchronising CUDA calls (waiting for the device included), and the
    device's busy share of the run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):           # the first profile also pays for starting the tracer
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"sort": 0.0, "gather": 0.0, "reduce": 0.0, "other": 0.0}
    sync_ms, syncs, top = 0.0, 0, []
    for e in prof.key_averages():
        name = e.key.lower()
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if e.key.startswith("cuda") and ("synchronize" in name or "memcpy" in name):
            sync_ms += e.cpu_time_total / 1e3
            syncs += e.count
        if "CUDA" not in str(getattr(e, "device_type", "")) or not dev_us or dev_us <= 0:
            continue
        kind = ("sort" if "sort" in name or "radix" in name else
                "gather" if "index" in name and "add" not in name or "gather" in name else
                "reduce" if any(w in name for w in ("scatter", "index_add", "reduce", "scan",
                                                     "cumsum", "bincount")) else "other")
        kinds[kind] += dev_us / 1e3
        top.append((dev_us / 1e3, e.key[:90], e.count))
    busy = sum(kinds.values())     # 0: the profiler saw no device time on this machine
    top.sort(reverse=True)
    return {"device_ms": kinds, "device_busy_ms": busy, "host_sync_ms": sync_ms,
            "host_sync_calls": syncs, "wall_ms": wall_ms,
            "device_busy_share": busy / wall_ms if wall_ms else None,
            "top_kernels": [{"ms": round(t, 3), "kernel": k, "calls": c} for t, k, c in top[:8]]}


# ----------------------------------------------------------------------
# G1: the ten questions in the pandas solution's form, and the groupby API
# ----------------------------------------------------------------------

RADIX_TIER = ["digit_histogram", "tile_sort_data", "merge_scatter", "bucket_aggregate"]
ONEHOT_TIER = ["onehot_groupby_aggregate"]
# the kernels each question (cudf_tpu_torch/models/g1.py) must launch at
# 1e8 rows: one dictionary or integer key takes the one-hot tier at K <= 4096
# (q1 id1, q4 id4) and the radix tier above (q3 and q7 id3, q5 id6); two or
# more keys take the sort tier, which launches none
G1_NEEDS = {"q1": ONEHOT_TIER, "q2": [], "q3": RADIX_TIER, "q4": ONEHOT_TIER,
            "q5": RADIX_TIER, "q6": [], "q7": RADIX_TIER, "q8": [], "q9": [], "q10": []}


def _first_groups(codes, G):
    """Plain: the codes in [0, G) that occur, in order of first appearance
    (scatter_reduce_ "amin" of row ids), and each row's position among them."""
    n, dev = codes.numel(), codes.device
    first = torch.full((G,), n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, codes, torch.arange(n, device=dev), "amin")
    present = torch.nonzero(first < n).squeeze(1)
    groups = present[torch.argsort(first[present])]
    pos = torch.empty(G, dtype=torch.int64, device=dev)
    pos[groups] = torch.arange(groups.numel(), device=dev)
    return groups, pos[codes]


def _sums(gpos, G, v):
    """Plain index_add_ sums: int64 (in v's dtype when every sum fits, as
    pandas gives them) or float64."""
    acc = torch.float64 if v.is_floating_point() else torch.int64
    s = torch.zeros(G, dtype=acc, device=v.device).index_add_(0, gpos, v.to(acc))
    if not v.is_floating_point():
        info = torch.iinfo(v.dtype)
        lo, hi = (int(x) for x in torch.aminmax(s))
        if info.min <= lo and hi <= info.max:
            s = s.to(v.dtype)
    return s


def _counts(gpos, G):
    return torch.bincount(gpos, minlength=G)


def _col(df, name):
    return df._table[name].data


def plain_g1(q, df):
    """The ten questions in plain PyTorch, written apart from the port:
    codes (dictionary codes, id - 1, packed for several keys), groups by
    first appearance, index_add_ / bincount / scatter_reduce_ per group;
    q9 in two passes; q10 over two packed int64 keys (id1, id2, id3) and
    (id4, id5, id6) with a stable sort.  {column: tensor}, dictionary keys
    as their codes."""
    id1, id2, id3 = (_col(df, n).long() for n in ("id1", "id2", "id3"))
    K3 = df._table["id3"].keys.length
    if q == "q1":
        groups, gpos = _first_groups(id1, K_LOW)
        return {"id1": groups.int(), "v1": _sums(gpos, groups.numel(), _col(df, "v1"))}
    if q == "q2":
        groups, gpos = _first_groups(id1 * K_LOW + id2, K_LOW * K_LOW)
        return {"id1": (groups // K_LOW).int(), "id2": (groups % K_LOW).int(),
                "v1": _sums(gpos, groups.numel(), _col(df, "v1"))}
    if q in ("q3", "q7"):
        groups, gpos = _first_groups(id3, K3)
        G = groups.numel()
        if q == "q3":
            return {"id3": groups.int(), "v1": _sums(gpos, G, _col(df, "v1")),
                    "v3": _sums(gpos, G, _col(df, "v3")) / _counts(gpos, G)}
        v1, v2 = _col(df, "v1"), _col(df, "v2")
        mx = torch.full((G,), torch.iinfo(v1.dtype).min, dtype=v1.dtype,
                        device=v1.device).scatter_reduce_(0, gpos, v1, "amax")
        mn = torch.full((G,), torch.iinfo(v2.dtype).max, dtype=v2.dtype,
                        device=v2.device).scatter_reduce_(0, gpos, v2, "amin")
        return {"id3": groups.int(), "range_v1_v2": mx - mn}
    if q in ("q4", "q5"):
        key = "id4" if q == "q4" else "id6"
        groups, gpos = _first_groups(_col(df, key).long() - 1, K_LOW if q == "q4" else K_HIGH)
        G = groups.numel()
        out = {key: (groups + 1).int()}
        for v in ("v1", "v2", "v3"):
            s = _sums(gpos, G, _col(df, v))
            out[v] = s.double() / _counts(gpos, G) if q == "q4" else s
        return out
    if q == "q9":
        groups, gpos = _first_groups(id2 * K_LOW + _col(df, "id4").long() - 1, K_LOW * K_LOW)
        G = groups.numel()
        cnt = _counts(gpos, G)
        x, y = _col(df, "v1").double(), _col(df, "v2").double()
        dx = x - (_sums(gpos, G, x) / cnt)[gpos]
        dy = y - (_sums(gpos, G, y) / cnt)[gpos]
        r = _sums(gpos, G, dx * dy) / torch.sqrt(_sums(gpos, G, dx * dx) * _sums(gpos, G, dy * dy))
        return {"id2": (groups // K_LOW).int(), "id4": (groups % K_LOW + 1).int(), "r2": r * r}
    if q == "q10":
        k1 = (id1 * K_LOW + id2) * K3 + id3
        k2 = ((_col(df, "id4").long() - 1) * K_LOW + _col(df, "id5").long() - 1) * K_HIGH \
            + _col(df, "id6").long() - 1
        perm = torch.sort(k2, stable=True).indices
        perm = perm[torch.sort(k1[perm], stable=True).indices]
        s1, s2 = k1[perm], k2[perm]
        new = torch.ones_like(s1, dtype=torch.bool)
        new[1:] = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
        run = torch.cumsum(new, 0) - 1
        starts = torch.nonzero(new).squeeze(1)
        first_row = perm[starts]                  # stable: each run's first row
        order = torch.argsort(first_row)          # groups by first appearance
        G = starts.numel()
        gpos = torch.empty_like(run)
        gpos[perm] = run
        rank = torch.empty_like(order)
        rank[order] = torch.arange(G, device=order.device)
        gpos = rank[gpos]
        a, b = k1[first_row[order]], k2[first_row[order]]
        return {"id1": (a // (K_LOW * K3)).int(), "id2": (a // K3 % K_LOW).int(),
                "id3": (a % K3).int(), "id4": (b // (K_LOW * K_HIGH) + 1).int(),
                "id5": (b // K_HIGH % K_LOW + 1).int(), "id6": (b % K_HIGH + 1).int(),
                "v3": _sums(gpos, G, _col(df, "v3")), "v1": _counts(gpos, G)}
    if q == "q6":
        return plain_q6(df)
    return plain_q8(df)


G1_RTOL = {"q3": 1e-9, "q4": 1e-9, "q9": 1e-9}     # means and corr of float sums
# r and r2 near 0: the rounding of the centred sums is absolute (~1e-16 of
# sqrt(sxx * syy)), so r2 = r * r also gets an atol of 1e-15
CORR_ATOL = 1e-15


def answer_g1(q, res):
    """A question's result in plain_g1's form (q6 and q8 keep the port's
    frame, which check_q6 and check_q8 read)."""
    if q == "q9":
        idx = res.index
        return {"id2": idx._columns[0].data, "id4": idx._columns[1].data,
                "r2": res._column.data}
    return res


def check_g1(q, res, exp):
    """Keys, group order, counts and integer sums exact; float sums rtol
    1e-12, means and corr rtol 1e-9; returns the max abs error."""
    if q == "q6":
        return check_q6(f"G1 {q}", res, exp)
    if q == "q8":
        check_q8(f"G1 {q}", res, exp)
        return 0.0
    got = answer_g1(q, res)
    got = got if isinstance(got, dict) else {n: got._table[n] for n in got._table.names}
    check(list(got) == list(exp), f"G1 {q}: columns {list(got)}, expected {list(exp)}")
    err = 0.0
    for name, want in exp.items():
        g = got[name]
        if not isinstance(g, torch.Tensor):
            check(g.validity is None or bool(g.validity.all()), f"G1 {q} {name}: nulls")
            g = g.data
        err = max(err, same(g, want, f"G1 {q} {name}", float_rtol=G1_RTOL.get(q, 1e-12),
                            float_atol=CORR_ATOL if q == "q9" else 0.0))
    return err


def g1_question_phase(df, smi, wrappers, drive, plains):
    """The ten questions at 1e8 rows: together (the path's launches), then
    each alone with every count at 0 before it, launching exactly
    G1_NEEDS' kernels, each call of which is replayed against its plain
    version; each answer against plain_g1; q9's apply form at 1e7 rows
    against its corr form; profiles of q2 and q10; medians of 7 warm runs
    beside plain PyTorch.  Returns the launches by question, the replayed
    calls by kernel and the times."""
    from cudf_tpu_torch.models import g1

    results = drive("g1_questions", lambda: {q: fn(df) for q, fn in g1.QUESTIONS.items()})
    for q in g1.QUESTIONS:
        err = check_g1(q, results.pop(q), plain_g1(q, df))
        log(f"phase 4 G1 question {q} (pandas solution form) agrees with plain torch, "
            f"max abs err {err}")
    torch.cuda.empty_cache()
    by_q, calls = {}, {}
    for q, fn in g1.QUESTIONS.items():            # alone, every count at 0 before
        by_q[q] = run_replayed(f"G1 {q}", q, lambda: fn(df), wrappers, plains, calls,
                               needs=G1_NEEDS[q])
    log(f"phase 4 G1 questions: launches by question {by_q}")
    small = df.head(N // 10)
    t0 = time.perf_counter()
    by_apply = g1.q9_apply(small)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    by_corr = g1.q9(small)
    keys = [by_apply._table[n].data for n in ("id2", "id4")]
    for got, want in zip(keys, by_corr.index._columns[:2]):
        same(got, want.data, "q9 apply form keys")
    err = same(by_apply._table[0].data, by_corr._column.data, "q9 apply form r2", 1e-9,
               CORR_ATOL)
    log(f"phase 4 G1 q9's apply form at 1e7 rows ({len(by_apply)} groups, a host loop) "
        f"equals its corr form, max abs err {err}; one run {apply_s:.3f} s [{smi}]")
    del small, by_apply, by_corr
    for q in ("q2", "q10"):
        log(f"phase 4 G1 {q} torch.profiler split: " + json.dumps(
            {f"g1_{q}_profile": profile_split(lambda: g1.QUESTIONS[q](df)), "card": smi}))
    times = {"q9_apply_1e7_s": apply_s}
    for q, fn in g1.QUESTIONS.items():
        ms = device_ms(lambda: fn(df))
        plain = device_ms(lambda: plain_g1(q, df))
        times[q] = {"ms": ms, "plain_ms": plain}
        log(f"phase 5 G1 question {q}: {ms:.3f} ms = {N / ms * 1e3:.4g} rows/s; plain torch "
            f"{plain:.3f} ms = {N / plain * 1e3:.4g} rows/s [{smi}]")
        torch.cuda.empty_cache()
    return by_q, calls, times


def _plain_ewm(codes, x, alpha):
    """Plain: each row's adjusted weighted mean within its group (no nulls),
    the rows group by group in row order: a stable sort by code, then
    num and den of the recurrence s_t = x_t + (1 - alpha) s_{t-1}, each a
    segmented doubling sum (at distance d a row adds (1 - alpha)^d times
    the row d before, within its group)."""
    order = torch.sort(codes, stable=True).indices
    c, xs = codes[order], x[order]
    num, den = xs.clone(), torch.ones_like(xs)
    d, n = 1, xs.numel()
    while d < n:
        same_g = c[d:] == c[:-d]
        w = (1.0 - alpha) ** d
        num = torch.cat([num[:d], num[d:] + torch.where(same_g, w * num[:-d], 0.0)])
        den = torch.cat([den[:d], den[d:] + torch.where(same_g, w * den[:-d], 0.0)])
        d *= 2
    return order, num / den


def api_cases(df, dev):
    """name: (call, its answer as {name: tensor}, plain version, rtol,
    kernels it must launch) for the groupby API phase at G1 1e8 (ewm at
    1e7)."""
    from cudf_tpu_torch.ops import groupby as gb

    id4c, id6c = _col(df, "id4").long() - 1, _col(df, "id6").long() - 1
    v1, v2, v3 = _col(df, "v1"), _col(df, "v2"), _col(df, "v3")
    small = df.head(N // 10)
    m = int(torch.bincount(id4c).median())

    def sorted_groups(codes, G):
        cnt = torch.bincount(codes, minlength=G)
        present = torch.nonzero(cnt).squeeze(1)
        return present, cnt

    def p_sum():
        present, _ = sorted_groups(id4c, K_LOW)
        return {"id4": (present + 1).int(), "v3": _sums(id4c, K_LOW, v3)[present]}

    def p_transform(codes, G):
        return {"v3": (_sums(codes, G, v3) / torch.bincount(codes, minlength=G).clamp(min=1))[
            codes]}

    def moments():
        cnt = torch.bincount(id4c, minlength=K_LOW)
        x, y = v1.double(), v2.double()
        dx = x - (_sums(id4c, K_LOW, x) / cnt)[id4c]
        dy = y - (_sums(id4c, K_LOW, y) / cnt)[id4c]
        return cnt, [_sums(id4c, K_LOW, a * b) for a, b in ((dx, dx), (dx, dy), (dy, dy))]

    def p_pair(which):
        cnt, (sxx, sxy, syy) = moments()
        if which == "corr":
            r = sxy / torch.sqrt(sxx * syy)
            cells = [torch.ones_like(r), r, r, torch.ones_like(r)]
        else:
            cells = [s / (cnt - 1) for s in (sxx, sxy, sxy, syy)]
        return {"v1": torch.stack(cells[:2], 1).reshape(-1),
                "v2": torch.stack(cells[2:], 1).reshape(-1)}

    def p_describe():
        cnt = torch.bincount(id4c, minlength=K_LOW)
        perm = torch.sort(v3, stable=True).indices
        perm = perm[torch.sort(id4c[perm], stable=True).indices]
        xs = v3[perm]
        starts = torch.cumsum(cnt, 0) - cnt
        mean = _sums(id4c, K_LOW, v3) / cnt
        d = v3 - mean[id4c]
        out = {"count": cnt.double(), "mean": mean,
               "std": torch.sqrt(_sums(id4c, K_LOW, d * d) / (cnt - 1)), "min": xs[starts]}
        for q in (0.25, 0.5, 0.75):
            pos = q * (cnt - 1).double()
            lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
            a, b = xs[starts + lo], xs[starts + hi]
            out[f"{int(q * 100)}%"] = a + (pos - lo) * (b - a)
        out["max"] = xs[starts + cnt - 1]
        return out

    def p_rank():
        pair = id4c * 5 + (v1.long() - 1)               # v1 in 1..5
        cnt = torch.bincount(pair, minlength=K_LOW * 5).view(K_LOW, 5)
        less = (torch.cumsum(cnt, 1) - cnt).reshape(-1)
        return {"v1": less[pair].double() + (cnt.reshape(-1)[pair].double() + 1) / 2}

    def p_ngroup():
        present = torch.bincount(id6c, minlength=K_HIGH) > 0
        return {"ngroup": (torch.cumsum(present.long(), 0) - 1)[id6c]}

    def p_filter():
        keep = torch.bincount(id4c, minlength=K_LOW)[id4c] > m
        rows = torch.nonzero(keep).squeeze(1)
        return {"rows": rows, "v3": v3[rows]}

    def p_ewm():
        c = _col(small, "id4").long()
        order, vals = _plain_ewm(c, _col(small, "v3"), 0.1)
        return {"id4": _col(small, "id4")[order], "label": order, "v3": vals}

    pair_codes = id4c * K_LOW + _col(df, "id5").long() - 1

    def p_ops(agg):
        present, cnt = sorted_groups(pair_codes, K_LOW * K_LOW)
        gpos = torch.searchsorted(present, pair_codes)
        G = present.numel()
        if agg == "sum_of_squares":
            return {agg: _sums(gpos, G, v2.double() ** 2)}
        if agg == "m2":
            x = v2.double()
            d = x - (_sums(gpos, G, x) / cnt[present])[gpos]
            return {agg: _sums(gpos, G, d * d)}
        bits = torch.zeros(G, dtype=torch.int32, device=v2.device)
        for b in range(4):                               # v2 in 1..15
            hit = torch.zeros(G, dtype=torch.int32, device=v2.device).scatter_reduce_(
                0, gpos, (v2 >> b) & 1, "amax")
            bits |= hit << b
        return {agg: bits}

    def ops_call(agg):
        g = gb.make_grouper([df._table["id4"], df._table["id5"]])
        return gb.aggregate(df._table["v2"], g, agg)

    def frame_cols(res):
        return {n: res._table[n].data for n in res._table.names}

    return {
        "sum_id4": (lambda: df.groupby("id4")["v3"].sum(),
                    lambda r: {"id4": r.index.column().data, "v3": r._column.data},
                    p_sum, 1e-12, ONEHOT_TIER),
        "transform_mean_id4": (lambda: df.groupby("id4")["v3"].transform("mean"),
                               lambda r: {"v3": r._column.data},
                               lambda: p_transform(id4c, K_LOW), 1e-9, ONEHOT_TIER),
        "transform_mean_id6": (lambda: df.groupby("id6")["v3"].transform("mean"),
                               lambda r: {"v3": r._column.data},
                               lambda: p_transform(id6c, K_HIGH), 1e-9, RADIX_TIER),
        "corr_id4": (lambda: df.groupby("id4")[["v1", "v2"]].corr(), frame_cols,
                     lambda: p_pair("corr"), 1e-9, []),
        "cov_id4": (lambda: df.groupby("id4")[["v1", "v2"]].cov(), frame_cols,
                    lambda: p_pair("cov"), 1e-9, []),
        "describe_id4": (lambda: df.groupby("id4")["v3"].describe(), frame_cols,
                         p_describe, 1e-9, []),
        "rank_average_id4": (lambda: df.groupby("id4")["v1"].rank(method="average"),
                             lambda r: {"v1": r._column.data}, p_rank, 0.0, []),
        "ngroup_id6": (lambda: df.groupby("id6").ngroup(),
                       lambda r: {"ngroup": r._column.data}, p_ngroup, 0.0, []),
        "filter_id4": (lambda: df.groupby("id4").filter(lambda g: len(g) > m),
                       lambda r: {"rows": r.index.column().data, "v3": r._table["v3"].data},
                       p_filter, 0.0, []),
        "ewm_mean_id4_1e7": (lambda: small.groupby("id4")["v3"].ewm(alpha=0.1).mean(),
                             lambda r: {"id4": r.index._columns[0].data,
                                        "label": r.index._columns[1].data,
                                        "v3": r._column.data}, p_ewm, 1e-9, []),
        **{f"ops_{agg}_id4_id5": ((lambda a=agg: ops_call(a)),
                                  (lambda r, a=agg: {a: r.data}),
                                  (lambda a=agg: p_ops(a)), 1e-9 if agg == "m2" else 1e-12, [])
           for agg in ("sum_of_squares", "m2", "bitwise_or")},
    }


def g1_api_phase(df, smi, wrappers, plains):
    """Each groupby API call at G1 1e8 (ewm at 1e7) alone, every count at 0
    before it, launching exactly its kernels (each call replayed against
    its plain version), its answer against a plain PyTorch version, then
    timed beside it.  Returns the launches by call, the replayed calls by
    kernel and the times."""
    by_call, calls, times = {}, {}, {}
    for name, (run, answer, plain, rtol, needs) in api_cases(df, df.device).items():
        by_call[name] = run_replayed(f"G1 API {name}", name, run, wrappers, plains, calls,
                                     needs=needs)
        got, exp = answer(run()), plain()
        check(list(got) == list(exp), f"G1 API {name}: {list(got)} vs {list(exp)}")
        err = max(same(got[k], exp[k], f"G1 API {name} {k}", float_rtol=rtol,
                       float_atol=CORR_ATOL if name.startswith("corr") else 0.0)
                  for k in exp)
        del got, exp
        row = {"ms": device_ms(run), "plain_ms": device_ms(plain), "max_abs_err": err}
        times[name] = row
        log(f"phase 4/5 G1 API {name} agrees with plain torch (max abs err {err}), launches "
            f"{by_call[name]}: {row['ms']:.3f} ms; plain torch {row['plain_ms']:.3f} ms "
            f"[{smi}]")
        torch.cuda.empty_cache()
    return by_call, calls, times


# ----------------------------------------------------------------------
# J1
# ----------------------------------------------------------------------

def fanout_ids(dev, gen, n):
    """int32 codes 0..n-1, each 1-3 times, shuffled."""
    ids = torch.repeat_interleave(torch.randperm(n, generator=gen, device=dev),
                                  torch.randint(1, 4, (n,), generator=gen, device=dev))
    return ids[torch.randperm(ids.numel(), generator=gen, device=dev)].int()


def probe_codes(dev, gen, n_dim):
    """N fact key codes uniform over 0..ceil(1.1 n_dim) - 1; those >= n_dim
    (no dim row) are -1, as the join's code pass leaves them."""
    lk = torch.randint(0, -(-11 * n_dim // 10), (N,), generator=gen, device=dev,
                       dtype=torch.int32)
    return torch.where(lk < n_dim, lk, -1)


def j1_kernel_phase(dev, gen, rp, ts):
    """D's id/idpay modes, B, C and H at J1 shapes, against their plain
    versions.  Returns {kernel: {mode: row}}."""
    modes = {"bucket_aggregate": {}, "digit_histogram": {}, "radix_scatter": {},
             "tile_sort_data": {}, "merge_scatter": {}, "window_probe": {}}
    n_dim = J1_DIMS["big"]
    rk = torch.randperm(n_dim, generator=gen, device=dev, dtype=torch.int32)
    rv = torch.randn(n_dim, generator=gen, device=dev, dtype=torch.float64)
    bits = rp.domain_bits(n_dim)
    rid1 = torch.arange(1, n_dim + 1, dtype=torch.int32, device=dev)
    pk_r, (prid, ppay), base_r, G = rp.radix_partition(rk, [rid1, rp.payload_bits(rv)], bits)
    del rid1
    size = G * rp.SPAN
    fill_junk(*[(2 * size,)] * 3)               # kernel D writes every slot itself
    before = rp.bucket_aggregate.launches
    ids, counts, pay = rp.window_tables(pk_r, prid, base_r, G, ppay)
    check(rp.bucket_aggregate.launches == before + 1, "D: id + idpay in one launch")
    (e_ids, e_pay), e_counts = rp.bucket_aggregate_plain(pk_r, [prid, ppay], base_r, G)
    same(ids, e_ids, "D id mode ids")
    same(counts, e_counts, "D id mode counts")
    same(pay, e_pay, "D idpay mode payload bits")
    check(torch.equal(pay[rk.long()], rp.payload_bits(rv)), "D idpay: payload bits not copied")
    del e_ids, e_counts, e_pay
    want = torch.zeros_like(ids)
    want[rk.long()] = torch.arange(1, n_dim + 1, device=dev)
    same(ids, want, "D id mode: build_row_id + 1 per key")
    check(int(counts.max()) == 1, "D id mode: J1 big's build is unique")
    del want, counts
    name = "id/idpay in one launch, J1 big build (1e8 keys, G = 16384, f64 payload)"
    modes["bucket_aggregate"][name] = timed_row(
        0.0, lambda: rp.window_tables(pk_r, prid, base_r, G, ppay),
        lambda: rp.bucket_aggregate_plain(pk_r, [prid, ppay], base_r, G),
        lambda: torch.zeros(size, dtype=torch.int64, device=dev).index_add_(0, pk_r, ppay),
        nbytes(pk_r, prid, ppay) + 3 * nbytes(ids), 3 * n_dim,
        occupancy=rp.bucket_aggregate_occupancy(2))
    show("D id + idpay in one launch (exact)", modes["bucket_aggregate"][name])
    fill_junk(*[(2 * size,)] * 2)
    ids1, counts1, _ = rp.window_tables(pk_r, prid, base_r, G)
    e_ids, e_counts = rp.bucket_aggregate_plain(pk_r, prid, base_r, G)
    same(ids1, e_ids, "D id mode alone: ids")
    same(counts1, e_counts, "D id mode alone: counts")
    del e_ids, e_counts
    name = "id alone (the J1 path's mode), J1 big build (1e8 keys, G = 16384)"
    modes["bucket_aggregate"][name] = timed_row(
        0.0, lambda: rp.window_tables(pk_r, prid, base_r, G),
        lambda: rp.bucket_aggregate_plain(pk_r, prid, base_r, G), None,
        nbytes(pk_r, prid, ids1, counts1), 2 * n_dim,
        occupancy=rp.bucket_aggregate_occupancy(1))
    show("D id mode alone (exact)", modes["bucket_aggregate"][name])
    del pk_r, prid, ppay, ids1, counts1

    lk = probe_codes(dev, gen, n_dim)
    rows_i = torch.arange(N, dtype=torch.int32, device=dev)
    nbits = bits - rp.WINDOW_BITS
    tile = rp.choose_tile(N, nbits)
    hist = rp.digit_histogram(lk, nbits, rp.WINDOW_BITS, tile)
    same(hist, rp.digit_histogram_plain(lk, nbits, rp.WINDOW_BITS, tile), "B hist (J1)")
    offsets, base_l = rp.partition_offsets(hist)
    m = int((lk >= 0).sum())
    pk_l, (pv_l,) = scatter_check(rp, lk, [rows_i], offsets, base_l, nbits, rp.WINDOW_BITS,
                                  tile, m, "C (J1)")
    window = torch.repeat_interleave(torch.arange(G, device=dev), base_l[1:] - base_l[:-1])
    check(torch.equal(pk_l[:m].long() >> rp.WINDOW_BITS, window), "C (J1): a key outside its window")
    del window
    shape = f"J1 big probe (1e8 keys, 2^{nbits} buckets, tile {tile})"
    cut = cut_of(rp, N, tile, nbits)
    modes["digit_histogram"][shape] = timed_row(
        0.0,
        lambda: rp.digit_histogram(lk, nbits, rp.WINDOW_BITS, tile),
        lambda: rp.digit_histogram_plain(lk, nbits, rp.WINDOW_BITS, tile), None,
        nbytes(lk, hist), N, shape=shape + " (the scatter route's)", cut=cut,
        occupancy=rp.partition_occupancy("digit_histogram", nbits))
    show("B at J1 big, 2^14 digits (exact)", modes["digit_histogram"][shape])
    modes["radix_scatter"][shape + ", one int32 payload"] = timed_row(
        0.0,
        lambda: rp.radix_scatter(lk, [rows_i], offsets, nbits, rp.WINDOW_BITS, tile),
        lambda: rp.radix_scatter_plain(lk, [rows_i], offsets, nbits, rp.WINDOW_BITS, tile),
        None, nbytes(lk, rows_i, offsets) + 2 * 4 * m, N,
        passes=f"two stable passes of {nbits - nbits // 2} and {nbits // 2} digit bits "
        f"(SCATTER_BITS = {rp.SCATTER_BITS}), each at tile {rp.choose_tile(N, nbits - nbits // 2)}",
        occupancy=rp.partition_occupancy("radix_scatter", nbits - nbits // 2, 4))
    show("C at J1 big (bit for bit)", modes["radix_scatter"][shape + ", one int32 payload"])
    del hist, offsets

    tile, st = rp.SORT_TILE, rp.MERGE_TILES * rp.SORT_TILE
    got = ts.tile_sort(lk, rows_i, tile=tile, alternate=True)
    exp = ts.tile_sort_data_plain(lk, [rows_i], tile, True)
    same_bits(got[0], exp[0], "E keys")
    same_bits(got[1], exp[1][0], "E rider")
    del got, exp
    lib = lk[:N // tile * tile].view(-1, tile)
    e_row = timed_row(
        0.0, lambda: ts.tile_sort(lk, rows_i, tile=tile, alternate=True),
        lambda: ts.tile_sort_data_plain(lk, [rows_i], tile, True),
        lambda: torch.sort(lib, dim=1, stable=True), 2 * nbytes(lk, rows_i),
        N * (tile.bit_length() - 1), shape="J1 big probe: 1e8 keys, one int32 rider, "
        "4096-key tiles, alternate, no mask (32 bits)")
    show("E at J1 big (bit for bit)", e_row)

    shift1 = rp.WINDOW_BITS + rp.PASS_BITS                 # the sorted route's two passes
    regions = 1 << (bits - shift1)
    name = f"J1 big probe, sorted route's first pass: 2^{bits - shift1} digits at shift {shift1}"
    modes["digit_histogram"][name] = hist_row(rp, lk, bits - shift1, shift1, st, name)
    off1, base1 = rp.partition_offsets(rp.digit_histogram(lk, bits - shift1, shift1, st),
                                       align=st)
    rows1 = (-(-N // st) + regions) * st
    shape1 = f"J1 big probe, first pass: 1e8 rows, mask_bits {bits}, one int32 payload"
    f_row, g_row, (k1, (r1,)) = sorted_pass(rp, ts, lk, [rows_i], bits - shift1, shift1, off1,
                                            base1, bits, shape1, out_rows=rows1)
    modes["tile_sort_data"][shape1] = f_row
    modes["merge_scatter"][shape1] = g_row
    show("F at J1 big, first pass (bit for bit)", f_row)
    show("G at J1 big, first pass (bit for bit)", g_row)
    region = torch.searchsorted(base1[1:], torch.arange(rows1 // st, device=dev) * st,
                                right=True).clamp_(max=regions - 1)
    name = (f"J1 big probe, sorted route's second pass: {rows1:.3g} keys, 2^{rp.PASS_BITS} "
            f"digits at shift {rp.WINDOW_BITS}")
    modes["digit_histogram"][name] = hist_row(rp, k1, rp.PASS_BITS, rp.WINDOW_BITS, st, name)
    off2, base2 = rp.partition_offsets(rp.digit_histogram(k1, rp.PASS_BITS, rp.WINDOW_BITS, st),
                                       region, regions)
    shape2 = (f"J1 big probe, second pass: {rows1:.3g} rows, mask_bits {shift1}, 2^7 digits "
              "per region, one int32 payload")
    f_row, g_row, _ = sorted_pass(rp, ts, k1, [r1], rp.PASS_BITS, rp.WINDOW_BITS, off2, base2,
                                  shift1, shape2)
    check(torch.equal(base2, base_l), "G (J1 second pass): windows other than C's")
    del k1, r1, off1, off2, region
    modes["tile_sort_data"][shape2] = f_row
    modes["merge_scatter"][shape2] = g_row
    show("F at J1 big, second pass (bit for bit)", f_row)
    show("G at J1 big, second pass (bit for bit)", g_row)
    route_ms = route_phase(dev, rp, lk, [rows_i], bits, "J1 big probe")
    pk_sp, _, base_sp, _ = rp.radix_partition(lk[:N // 100], [], bits)   # a sparse probe
    del lk

    tab = ids.view(1, -1)
    found, bid, _ = probe_check(rp, pk_l, base_l, tab)
    check(torch.equal(rk[bid], pk_l[found]), "H (J1 big): a match off its key")
    idx = pk_l[:m].long()
    main = probe_row(rp, pk_l, base_l, tab, "J1 big: 1e8 probe rows, 16384 windows, one table "
                     "of 1.34e8 slots", lambda: torch.take(ids, idx))
    show("H at J1 big (exact)", main)
    probe_check(rp, pk_sp, base_sp, tab)
    idx_sp = pk_sp[:int(base_sp[-1])].long()
    name = "J1 big's table, 1e6 probe rows (sparse: ~55 rows a window of 8192 slots)"
    modes["window_probe"][name] = probe_row(rp, pk_sp, base_sp, tab, name,
                                            lambda: torch.take(ids, idx_sp))
    show("H, sparse probe of J1 big's table (exact)", modes["window_probe"][name])
    del pk_sp, base_sp, idx_sp
    found, bid, out = probe_check(rp, pk_l, base_l, tab, pay, torch.float64)
    check(torch.equal(rp.payload_bits(out)[found], rp.payload_bits(rv)[bid]),
          "H (J1 big): a payload not copied")
    del out, found, bid
    name = "J1 big with the f64 payload through the table"
    row = probe_row(rp, pk_l, base_l, tab, name, None, pay, torch.float64)
    row["two_calls_ms"] = device_ms(lambda: (torch.take(ids, idx), torch.take(pay, idx)))
    row["two_calls"] = "torch.take(ids, idx) + torch.take(pay, idx): two calls, ids and payload"
    modes["window_probe"][name] = row
    show("H at J1 big with payload (bits copied)", row)
    log(f"  two calls (torch.take of ids, then of the payload): {row['two_calls_ms']} ms")
    del ids, pay, tab, idx, pk_l, pv_l, rk, rv

    n_small = J1_DIMS["small"]
    ids_s, _, unique, _ = rp.build_join_tables(
        torch.randperm(n_small, generator=gen, device=dev, dtype=torch.int32), n_small)
    check(unique, "J1 small's build is unique")
    lk = probe_codes(dev, gen, n_small)                   # one window: not partitioned
    base_s = torch.tensor([0, N], dtype=torch.int64, device=dev)
    probe_check(rp, lk, base_s, ids_s.view(1, -1))
    idx = lk.clamp(min=0).long()
    name = "J1 small: 1e8 probe rows in one window (~1.2e4 rows a slot), one table"
    modes["window_probe"][name] = probe_row(rp, lk, base_s, ids_s.view(1, -1), name,
                                            lambda: torch.take(ids_s, idx))
    show("H at J1 small (exact)", modes["window_probe"][name])
    del lk, idx, ids_s

    n_med = J1_DIMS["medium"]
    ids_m, _, unique, _ = rp.build_join_tables(
        torch.randperm(n_med, generator=gen, device=dev, dtype=torch.int32), n_med)
    check(unique, "J1 medium's build is unique")
    dup = fanout_ids(dev, gen, n_med)
    tables, mult = rp.ordinal_tables(dup, n_med)
    check(mult == 3, f"H m=3: fan-out {mult}")
    lk = probe_codes(dev, gen, n_med)
    bits_m = rp.domain_bits(n_med)                         # 17: one pass at 2^4 digits
    nbits_m = bits_m - rp.WINDOW_BITS
    name = f"J1 medium probe, sorted route's single pass: 2^{nbits_m} digits"
    modes["digit_histogram"][name] = hist_row(rp, lk, nbits_m, rp.WINDOW_BITS, st, name)
    off_m, base_m = rp.partition_offsets(rp.digit_histogram(lk, nbits_m, rp.WINDOW_BITS, st))
    shape = (f"J1 medium probe, single pass: 1e8 rows, 2^{nbits_m} digits, mask_bits {bits_m}, "
             "one int32 payload")
    f_row, g_row, _ = sorted_pass(rp, ts, lk, [rows_i], nbits_m, rp.WINDOW_BITS, off_m, base_m,
                                  bits_m, shape)
    modes["tile_sort_data"][shape] = f_row
    modes["merge_scatter"][shape] = g_row
    show("F at J1 medium (bit for bit)", f_row)
    show("G at J1 medium (bit for bit)", g_row)
    del off_m, base_m
    pk_m, (pv_m,), base_m, _ = rp.radix_partition(lk, [rows_i], bits_m)
    del lk
    idx = pk_m[:int(base_m[-1])].long()
    probe_check(rp, pk_m, base_m, ids_m.view(1, -1))
    name = "J1 medium: 1e8 probe rows, 16 windows (~6.9e2 rows a slot), one table"
    modes["window_probe"][name] = probe_row(rp, pk_m, base_m, ids_m.view(1, -1), name,
                                            lambda: torch.take(ids_m, idx))
    show("H at J1 medium (exact)", modes["window_probe"][name])
    probe_check(rp, pk_m, base_m, tables)
    name = "J1 medium, m = 3 stacked tables (keys 1-3 times)"
    modes["window_probe"][name] = probe_row(rp, pk_m, base_m, tables, name,
                                            lambda: tables.index_select(1, idx))
    show("H m=3 at J1 medium (exact)", modes["window_probe"][name])
    return {"window_probe": main, "tile_sort": e_row}, modes, route_ms


def hist_row(rp, keys, nbits, shift, tile, shape):
    """Kernel B exact against its plain version at one sorted-route shape
    (16384-key tiles), and its row."""
    hist = rp.digit_histogram(keys, nbits, shift, tile)
    same(hist, rp.digit_histogram_plain(keys, nbits, shift, tile), f"B hist ({shape})")
    row = timed_row(0.0, lambda: rp.digit_histogram(keys, nbits, shift, tile),
                    lambda: rp.digit_histogram_plain(keys, nbits, shift, tile), None,
                    nbytes(keys, hist), keys.numel(), shape=shape,
                    cut=cut_of(rp, keys.numel(), tile, nbits),
                    occupancy=rp.partition_occupancy("digit_histogram", nbits))
    show(f"B, {shape}", row)
    return row


def cut_of(rp, n, tile, nbits):
    """How kernel B cuts this shape's tiles over blocks."""
    parts, part_len = rp.tile_parts(-(-n // tile), tile, nbits, torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count)
    return {"tiles": -(-n // tile), "parts": parts, "part_len": part_len}


def scatter_check(rp, keys, payloads, offsets, base, nbits, shift, tile, rows, what):
    """Kernel C bit for bit against its plain version (a stable argsort by
    digit) in the valid rows, keys and every payload, its outputs over
    junk; returns its output."""
    m = int(base[-1])
    check(m == rows, f"{what}: {m} partitioned rows of {rows}")
    fill_junk((keys.numel(),), *[(p.numel() * p.element_size() // 4,) for p in payloads])
    pk, pv = rp.radix_scatter(keys, payloads, offsets, nbits, shift, tile)
    ek, ev = rp.radix_scatter_plain(keys, payloads, offsets, nbits, shift, tile)
    same_bits(pk[:m], ek[:m], f"{what} keys")
    for got, exp in zip(pv, ev):
        same_bits(got[:m], exp[:m], f"{what} payloads")
    return pk, pv


def fill_junk(*shapes):
    """Allocate int32 tensors of these shapes filled with 0x7f7f7f7f and
    free them, so that the caching allocator hands their blocks, junk and
    all, to the next allocations of the same sizes."""
    junk = [torch.full(sh, 0x7F7F7F7F, dtype=torch.int32, device="cuda") for sh in shapes]
    torch.cuda.synchronize()
    del junk


def probe_check(rp, pk, base, tables, pay=None, pay_dtype=None):
    """Kernel H exact against its plain version, its outputs allocated
    over junk: every row past base[-1] and every row without a match
    reads -1 (payload 0).  Returns (rows found in table 0, their bids,
    the payload)."""
    n, m = pk.numel(), tables.shape[0]
    fill_junk((m, n), (2 * n,))
    bids, out = rp.window_probe(pk, base, tables, pay, pay_dtype)
    eb, eo = rp.window_probe_plain(pk, base, tables, pay, pay_dtype)
    same(bids, eb, f"H bids (m = {m}, {n} rows)")
    check(bool((bids[:, int(base[-1]):] == -1).all()), "H: a row past base[-1] matched")
    if pay is not None:
        same(rp.payload_bits(out), rp.payload_bits(eo), "H payload bits")
        check(bool((out[bids[0] < 0] == 0).all()), "H: a payload without a match")
    found = torch.nonzero(bids[0] >= 0).squeeze(1)
    return found, bids[0][found].long(), out


def probe_row(rp, pk, base, tables, shape, library, pay=None, pay_dtype=None):
    """Kernel H's row at one shape, timed also with every window staged
    (ms_staged) and with none (ms_direct).  Bound: the keys of the
    windows' rows read, bids (and payload) written, and the table (and
    payload) entries the keys touch read once."""
    rows = int(base[-1])
    k = pk[:rows].long()
    touched = torch.zeros(tables.shape[1], dtype=torch.bool, device=pk.device)
    touched[k[k >= 0]] = True
    n_touched = int(touched.sum())
    del touched, k
    m, n = tables.shape[0], pk.numel()
    moved = 4 * rows + 4 * m * n + 8 * m * n_touched
    if pay is not None:
        moved += pay_dtype.itemsize * n + 8 * n_touched
    row = timed_row(0.0, lambda: rp.window_probe(pk, base, tables, pay, pay_dtype),
                    lambda: rp.window_probe_plain(pk, base, tables, pay, pay_dtype),
                    library, moved, m * rows, shape=shape, n_touched=n_touched,
                    stage_min_rows=rp.STAGE_MIN_ROWS)
    row["ms_staged"] = device_ms(
        lambda: rp.window_probe(pk, base, tables, pay, pay_dtype, stage_min_rows=1))
    row["ms_direct"] = device_ms(
        lambda: rp.window_probe(pk, base, tables, pay, pay_dtype, stage_min_rows=1 << 40))
    return row


def j1_frames(ct, dev, gen):
    """{name: DataFrame}: fact_<size> (1e8 rows, keys for that dim) and
    dim_<size> for each J1 dim size, and dim_medium_fanout."""
    v1 = torch.randn(N, generator=gen, device=dev, dtype=torch.float64)
    frames = {}
    for size, n_dim in J1_DIMS.items():
        ids = torch.randint(1, -(-11 * n_dim // 10) + 1, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
        frames[f"fact_{size}"] = ct.DataFrame({"id": ids, "v1": v1})
        frames[f"dim_{size}"] = ct.DataFrame({
            "id": torch.randperm(n_dim, generator=gen, device=dev, dtype=torch.int32) + 1,
            "v2": torch.randn(n_dim, generator=gen, device=dev, dtype=torch.float64)})
    ids = fanout_ids(dev, gen, J1_DIMS["medium"]) + 1
    frames["dim_medium_fanout"] = ct.DataFrame({
        "id": ids, "v2": torch.randn(ids.numel(), generator=gen, device=dev,
                                     dtype=torch.float64)})
    return frames


J1_QUERIES = {          # name: (left frame, right frame, right side unique)
    "q1_small": ("fact_small", "dim_small", True),
    "q2_medium": ("fact_medium", "dim_medium", True),
    "q5_big": ("fact_big", "dim_big", True),
    "medium_fanout3": ("fact_medium", "dim_medium_fanout", False),
    "medium_swapped": ("dim_medium", "fact_medium", False),
}


def plain_join(lk, rk, unique):
    """(li, ri) int64 of an inner join of keys >= 1, in left-row order with
    right-row order inside: a dense table when rk is unique, else a
    stable sort + searchsorted + repeat_interleave."""
    dev = lk.device
    if unique:
        tbl = torch.full((int(torch.maximum(lk.max(), rk.max())),), -1, dtype=torch.int64,
                         device=dev)
        tbl[rk.long() - 1] = torch.arange(rk.numel(), device=dev)
        r = tbl[lk.long() - 1]
        li = torch.nonzero(r >= 0).squeeze(1)
        return li, r[li]
    sk, perm = torch.sort(rk, stable=True)
    lo = torch.searchsorted(sk, lk)
    cnt = torch.searchsorted(sk, lk, right=True) - lo
    M = int(cnt.sum())
    li = torch.repeat_interleave(torch.arange(lk.numel(), device=dev), cnt, output_size=M)
    within = torch.arange(M, device=dev) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt, output_size=M)
    return li, perm[torch.repeat_interleave(lo, cnt, output_size=M) + within]


def plain_merge(left, right, unique):
    """The same merge in plain PyTorch: {name: tensor}, key from the left."""
    li, ri = plain_join(left._table["id"].data, right._table["id"].data, unique)
    out = {n: c.data[li] for n, c in left._table.items()}
    out.update({n: c.data[ri] for n, c in right._table.items() if n != "id"})
    return out


def check_merge(name, res, exp):
    check(list(res._table.names) == list(exp), f"{name}: columns {res._table.names}")
    for col, want in exp.items():
        c = res._table[col]
        check(c.validity is None or bool(c.validity.all()), f"{name} {col}: nulls")
        same(c.data, want, f"{name} {col}", float_rtol=0.0)
    return len(res)


def j1_model_inputs(frames, size):
    n_dim = J1_DIMS[size]
    lk = frames[f"fact_{size}"]._table["id"].data
    rk = frames[f"dim_{size}"]._table["id"].data
    return torch.where(lk <= n_dim, lk - 1, -1), rk - 1, n_dim


def plain_probe(lcodes, rcodes, n_dim):
    """Per probe row the build row or -1, with a dense table."""
    tbl = torch.full((n_dim,), -1, dtype=torch.int32, device=lcodes.device)
    tbl[rcodes.long()] = torch.arange(rcodes.numel(), dtype=torch.int32, device=lcodes.device)
    return torch.where(lcodes >= 0, tbl[lcodes.clamp(min=0).long()], -1)


def check_j1_model(j1_join, rows, lcodes, rcodes, n_dim, size):
    _, pv, bid, unique = j1_join(lcodes, rows, rcodes, n_dim)
    check(unique, f"j1_join {size}: build not unique")
    exp = plain_probe(lcodes, rcodes, n_dim)
    found = bid >= 0
    order = torch.argsort(pv[found])
    check(torch.equal(pv[found][order].long(), torch.nonzero(exp >= 0).squeeze(1)),
          f"j1_join {size}: matched probe rows differ")
    check(torch.equal(bid[found][order], exp[exp >= 0]), f"j1_join {size}: build rows differ")


def plain_lookup(lk, rk):
    """Per left key the row of the (unique) right key equal to it, or -1:
    a dense table over keys >= 0."""
    size = int(torch.maximum(lk.max(), rk.max())) + 1
    tbl = torch.full((size,), -1, dtype=torch.int64, device=lk.device)
    tbl[rk.long()] = torch.arange(rk.numel(), device=lk.device)
    return tbl[lk.long()]


def plain_left_merge(left, right):
    """fact.merge(dim, on="id", how="left") in plain PyTorch: every left
    row in order, v2 NaN where no dim row matches."""
    r = plain_lookup(left._table["id"].data, right._table["id"].data)
    v2 = right._table["v2"].data
    return {"id": left._table["id"].data, "v1": left._table["v1"].data,
            "v2": torch.where(r >= 0, v2[r.clamp(min=0)], float("nan"))}


def check_left_merge(name, res, exp):
    check(list(res._table.names) == list(exp), f"{name}: columns {res._table.names}")
    for col, want in exp.items():
        c = res._table[col]
        valid = ~torch.isnan(want) if want.is_floating_point() else torch.ones_like(
            want, dtype=torch.bool)
        check(torch.equal(valid, torch.ones_like(valid) if c.validity is None else c.validity),
              f"{name} {col}: nulls differ")
        same(c.data[valid], want[valid], f"{name} {col}", float_rtol=0.0)
    return len(res)


def plain_full_join(lk, rk):
    """full_join maps of a unique right side: every left row with its
    match or -1, then the right rows no left row matched, in order."""
    r = plain_lookup(lk, rk)
    hit = torch.zeros(rk.numel(), dtype=torch.bool, device=lk.device)
    hit[r[r >= 0]] = True
    miss = torch.nonzero(~hit).squeeze(1)
    li = torch.cat([torch.arange(lk.numel(), device=lk.device),
                    torch.full_like(miss, -1)])
    return li, torch.cat([r, miss])


def j1_sort_merge_phase(ct, frames, drive, smi):
    """J1's left, outer, semi and anti joins through the sort-merge tier at
    1e8 fact rows, each against plain PyTorch (row order included) and
    timed beside it."""
    from cudf_tpu_torch.ops import join

    def key(name):
        return frames[name]._table["id"]

    runs = {
        "left_medium": (lambda: frames["fact_medium"].merge(frames["dim_medium"], on="id",
                                                            how="left"),
                        lambda: plain_left_merge(frames["fact_medium"], frames["dim_medium"])),
        "left_big": (lambda: frames["fact_big"].merge(frames["dim_big"], on="id", how="left"),
                     lambda: plain_left_merge(frames["fact_big"], frames["dim_big"])),
        "outer_medium": (lambda: join.full_join([key("fact_medium")], [key("dim_medium")]),
                         lambda: plain_full_join(key("fact_medium").data,
                                                 key("dim_medium").data)),
        "semi_big": (lambda: join.semi_join([key("fact_big")], [key("dim_big")]),
                     lambda: torch.nonzero(plain_lookup(key("fact_big").data,
                                                        key("dim_big").data) >= 0).squeeze(1)),
        "anti_big": (lambda: join.anti_join([key("fact_big")], [key("dim_big")]),
                     lambda: torch.nonzero(plain_lookup(key("fact_big").data,
                                                        key("dim_big").data) < 0).squeeze(1)),
    }
    results = drive("j1_sort_merge", lambda: {n: run() for n, (run, _) in runs.items()})
    for name, (_, plain) in runs.items():
        got, exp = results.pop(name), plain()
        if name.startswith("left"):
            rows = check_left_merge(f"J1 {name}", got, exp)
        else:
            got, exp = (got if isinstance(got, tuple) else (got,)), (
                exp if isinstance(exp, tuple) else (exp,))
            for g, e in zip(got, exp):
                same(g, e, f"J1 {name}")
            rows = got[0].numel()
        log(f"phase 4 J1 sort-merge {name}: {rows} rows, equal to plain torch")
        torch.cuda.empty_cache()
    for name, (run, plain) in runs.items():
        ms, plain_ms = device_ms(run), device_ms(plain)
        log(f"phase 5 J1 sort-merge {name}: {ms:.3f} ms = {N / ms * 1e3:.4g} probe rows/s; "
            f"plain torch {plain_ms:.3f} ms = {N / plain_ms * 1e3:.4g} probe rows/s [{smi}]")
        torch.cuda.empty_cache()


J1_DICT_KEYS = 100_000


def j1_dict_frames(ct, dev, gen, v1):
    """bench.py's bench_join_dict shape: 1e8 fact rows of codes over 1e5
    strings; a dim of 1e5 rows whose dictionary is a permutation of the
    same strings, each key once.  Returns (fact, dim)."""
    from cudf_tpu_torch.core.column import Column

    strings = [f"key{i:09d}" for i in range(J1_DICT_KEYS)]
    perm = torch.randperm(J1_DICT_KEYS, generator=gen, device=dev)
    dim_strings = [strings[i] for i in perm.tolist()]
    fact = ct.DataFrame({
        "key": Column.from_dictionary(
            torch.randint(0, J1_DICT_KEYS, (N,), generator=gen, device=dev, dtype=torch.int32),
            Column.from_strings(strings, device=dev)),
        "v1": v1})
    dim = ct.DataFrame({
        "key": Column.from_dictionary(
            torch.randperm(J1_DICT_KEYS, generator=gen, device=dev, dtype=torch.int32),
            Column.from_strings(dim_strings, device=dev)),
        "v2": torch.randn(J1_DICT_KEYS, generator=gen, device=dev, dtype=torch.float64)})
    return fact, dim


def plain_dict_merge(fact, dim):
    """fact.merge(dim, on="key") in plain PyTorch: the dim keys' fact
    codes from a host dictionary of the fact keys, then a dense table over
    the fact codes."""
    fk, dk = fact._table["key"], dim._table["key"]
    pos = {s: i for i, s in enumerate(fk.keys.host_strings())}
    remap = torch.tensor([pos.get(s, -1) for s in dk.keys.host_strings()],
                         dtype=torch.int64).to(fk.data.device)
    r = plain_lookup(fk.data, remap[dk.data.long()])
    li = torch.nonzero(r >= 0).squeeze(1)
    return {"key": fk.data[li], "v1": fact._table["v1"].data[li],
            "v2": dim._table["v2"].data[r[li]]}


def check_dict_merge(res, exp, fact):
    check(list(res._table.names) == list(exp), f"J1 dict: columns {res._table.names}")
    key = res._table["key"]
    check(key.dtype.is_dictionary and key.keys is fact._table["key"].keys,
          "J1 dict: the key is not the fact's dictionary column")
    same(key.data, exp["key"], "J1 dict key codes")
    for col in ("v1", "v2"):
        same(res._table[col].data, exp[col], f"J1 dict {col}", float_rtol=0.0)
    return len(res)


def j1_dict_phase(ct, dev, gen, v1, drive, smi):
    fact, dim = j1_dict_frames(ct, dev, gen, v1)
    res = drive("j1_dict", lambda: fact.merge(dim, on="key"))
    rows = check_dict_merge(res, plain_dict_merge(fact, dim), fact)
    del res
    log(f"phase 4 J1 dictionary-string key (bench_join_dict's shape): {rows} rows, equal to "
        "plain torch")
    ms, plain_ms = device_ms(lambda: fact.merge(dim, on="key")), device_ms(
        lambda: plain_dict_merge(fact, dim))
    log(f"phase 5 J1 dictionary-string merge: {ms:.3f} ms = {N / ms * 1e3:.4g} probe rows/s; "
        f"plain torch (host remap of 1e5 keys included) {plain_ms:.3f} ms = "
        f"{N / plain_ms * 1e3:.4g} probe rows/s [{smi}]")
    del fact, dim
    torch.cuda.empty_cache()


def beside_phase(dev, gen, rp, ha, other_dir):
    """Kernels A, D, B and C at their main shapes beside another checkout's
    (``--beside DIR``, e.g. the parent unpacked by ``git archive``), in
    this process on the same data: DIR's kernel library is built from its
    own sources and its wrappers are loaded beside this checkout's; four
    rounds in turns, each shape the median of REPS warm runs.  One process
    keeps out kernel D's process-to-process spread (PERF.md §6).
    Where DIR's wrappers take one value column a call, its q4 and q5
    shapes are one call a column."""
    import importlib.util
    from pathlib import Path
    from cudf_tpu_torch.kernels import _build

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    root = Path(other_dir).resolve() / "cudf_tpu_torch" / "kernels"
    libs = {"this": _build.library(),
            "beside": _build._Library(load("beside_build", root / "_build.py").build(), 0.0)}
    o_rp = load("beside_radix_partition", root / "radix_partition.py")
    o_ha = load("beside_hash_aggregate", root / "hash_aggregate.py")
    q = [torch.randint(lo, hi, (N,), generator=gen, device=dev, dtype=torch.int32)
         for lo, hi in ((1, 6), (1, 16))]
    q.append(torch.rand(N, generator=gen, device=dev, dtype=torch.float64) * 100)
    k100 = torch.randint(0, K_LOW, (N,), generator=gen, device=dev, dtype=torch.int32)
    k6 = torch.randint(0, K_HIGH, (N,), generator=gen, device=dev, dtype=torch.int32)
    pk, pv, base, G = rp.radix_partition(k6, q, 20)
    g1_nbits, g1_tile, g1_st = 7, rp.choose_tile(N, 7), rp.MERGE_TILES * rp.SORT_TILE
    g1_off, _ = rp.partition_offsets(rp.digit_histogram(k6, g1_nbits, rp.WINDOW_BITS, g1_tile))
    j1_bits = rp.domain_bits(J1_DIMS["big"])
    j1_nbits = j1_bits - rp.WINDOW_BITS
    j1_tile = rp.choose_tile(N, j1_nbits)
    lk = probe_codes(dev, gen, J1_DIMS["big"])
    rows_i = torch.arange(N, dtype=torch.int32, device=dev)
    j1_off, _ = rp.partition_offsets(rp.digit_histogram(lk, j1_nbits, rp.WINDOW_BITS, j1_tile))
    rk = torch.randperm(N, generator=gen, device=dev, dtype=torch.int32)
    rid1 = torch.arange(1, N + 1, dtype=torch.int32, device=dev)
    pay = rp.payload_bits(torch.randn(N, generator=gen, device=dev, dtype=torch.float64))
    jk, (jr, jp), jbase, jG = rp.radix_partition(rk, [rid1, pay], 27)
    del rk, rid1, pay
    torch.cuda.empty_cache()

    def shapes(r, h):
        lists_d, lists_a = hasattr(r, "MAX_AGG_COLUMNS"), hasattr(h, "MAX_COLUMNS")
        return {
            "A, bench K = 100's one f64 column": lambda: h.onehot_groupby_aggregate(
                k100, q[2], K_LOW, with_minmax=False),
            "A, q4's three columns": (
                (lambda: h.onehot_groupby_aggregate(k100, q, K_LOW, with_minmax=False))
                if lists_a else lambda: [h.onehot_groupby_aggregate(
                    k100, v, K_LOW, with_minmax=False) for v in q]),
            "D, q5's three columns over the sorted route": (
                (lambda: r.bucket_aggregate(pk, pv, base, G)) if lists_d else
                lambda: [r.bucket_aggregate(pk, v, base, G, with_counts=j == 0)
                         for j, v in enumerate(pv)]),
            "D, one f64 column over the sorted route": lambda: r.bucket_aggregate(
                pk, pv[2], base, G),
            "D, id alone at J1 big": lambda: r.window_tables(jk, jr, jbase, jG),
            "D, id + idpay at J1 big": lambda: r.window_tables(jk, jr, jbase, jG, jp),
            f"B, G1 K = 1e6 (2^7 digits, {g1_st}-key tiles: the sorted route's)":
                lambda: r.digit_histogram(k6, g1_nbits, rp.WINDOW_BITS, g1_st),
            f"B, J1 big probe (2^14 digits, {j1_tile}-key tiles)": lambda: r.digit_histogram(
                lk, j1_nbits, rp.WINDOW_BITS, j1_tile),
            f"C, G1 K = 1e6 (int32 + f64 payloads, {g1_tile}-key tiles)": lambda: r.radix_scatter(
                k6, q[1:], g1_off, g1_nbits, rp.WINDOW_BITS, g1_tile),
            "C, J1 big probe (one int32 payload)": lambda: r.radix_scatter(
                lk, [rows_i], j1_off, j1_nbits, rp.WINDOW_BITS, j1_tile),
        }

    calls = {"this": shapes(rp, ha), "beside": shapes(o_rp, o_ha)}
    out = {shape: {"this": [], "beside": []} for shape in calls["this"]}
    for rnd in range(4):
        for side in (("this", "beside") if rnd % 2 == 0 else ("beside", "this")):
            _build._library = libs[side]
            for shape, fn in calls[side].items():
                out[shape][side].append(device_ms(fn))
    _build._library = libs["this"]
    for shape, times in out.items():
        log(f"beside {shape}: this {[round(t, 3) for t in times['this']]} ms, "
            f"{other_dir} {[round(t, 3) for t in times['beside']]} ms")
    return out


def ptxas_lines(report, kernel=None):
    """ptxas's info and stack-frame lines, only those of the entry points
    whose name holds ``kernel`` when it is given."""
    out, keep = [], kernel is None
    for line in report:
        if "Compiling entry function" in line:
            keep = kernel is None or kernel in line
        if keep and ("ptxas info" in line or "stack frame" in line):
            out.append(line)
    return out


# ----------------------------------------------------------------------
# TPC-H through the LazyFrame engine
# ----------------------------------------------------------------------

TPCH_SCALES = (10, 1)
TPCH_PATH = ["onehot_groupby_aggregate", "digit_histogram", "tile_sort_data", "merge_scatter",
             "bucket_aggregate", "window_probe"]
# the kernels each query must launch at SF10 (as the card counts them):
# the radix tier's joins B, F, G, D and H; the one-hot tier's A where a
# query groups by one dictionary key (q4, q5, q9, q12); q4's semi join
# and q5's two-key join take the sort-merge tier, which launches none
TPCH_NEEDS = {"q1": [], "q3": TPCH_PATH[1:], "q4": TPCH_PATH[:1], "q5": TPCH_PATH,
              "q6": [], "q9": TPCH_PATH, "q10": TPCH_PATH[1:], "q12": TPCH_PATH,
              "q14": TPCH_PATH[1:]}


def agree(what, got, exp):
    """A query's answer against its plain version's (``tpch.answer``'s
    forms): keys, counts, strings and row order exact, floats rtol 1e-9;
    returns the max abs error."""
    if isinstance(exp, float):
        check(abs(got - exp) <= 1e-9 * abs(exp), f"{what}: {got} vs {exp}")
        return abs(got - exp)
    if isinstance(exp, torch.Tensor):
        return same(got, exp, what, float_rtol=1e-9)
    if isinstance(exp, dict):
        check(list(got) == list(exp), f"{what}: columns {list(got)}")
        return max(agree(f"{what} {k}", got[k], exp[k]) for k in exp)
    if isinstance(exp, tuple):
        return max(agree(f"{what}[{i}]", g, e) for i, (g, e) in enumerate(zip(got, exp)))
    check(got == exp, f"{what}: {got} vs {exp}")
    return 0.0


def check_tpch(name, res, exp):
    from cudf_tpu_torch.models import tpch

    return agree(f"TPC-H {name}", tpch.answer(name, res), exp)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


class KernelRecorder:
    """While active, every call of the named kernel wrappers, from any
    module of cudf_tpu_torch that bound them, is recorded with a copy of
    its arguments, so that each can be replayed against its plain version
    at the shapes the main path gave it."""

    def __init__(self, wrappers, names):
        self.wrappers = {n: wrappers[n] for n in names}
        self.calls = []
        self.patched = []

    class Recorded:
        """Stands for one wrapper: records each call, then makes it; its
        ``launches`` is the wrapper's own, which the wrapper counts."""

        def __init__(self, fn, name, calls):
            self.fn, self.name, self.calls = fn, name, calls

        def __call__(self, *args, **kwargs):
            bound = inspect.signature(self.fn).bind(*args, **kwargs)
            bound.apply_defaults()
            self.calls.append((self.name, _clone(dict(bound.arguments))))
            return self.fn(*args, **kwargs)

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, value):
            self.fn.launches = value

    def __enter__(self):
        for name, fn in self.wrappers.items():
            record = self.Recorded(fn, name, self.calls)
            for mod in [m for k, m in sys.modules.items() if k.startswith("cudf_tpu_torch")]:
                if getattr(mod, name, None) is fn:
                    setattr(mod, name, record)
                    self.patched.append((mod, name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.patched:
            setattr(mod, name, fn)
        self.patched = []


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return [x]


def _describe(args):
    """A recorded call's arguments: tensors as dtype[shape], the rest as text."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return f"{v.dtype}{list(v.shape)}".replace("torch.", "")
        return [one(t) for t in v] if isinstance(v, (list, tuple)) else str(v)
    return {k: one(v) for k, v in args.items()}


def replay_check(wrappers, plains, name, args, what):
    """One recorded kernel call against its plain version on the same
    inputs: bit for bit, apart from float sums of A and D (rtol 1e-12, the
    order of atomic adds) and kernel G's rows no run covers; returns the
    max abs error."""
    kernel, plain = wrappers[name], plains[name]
    got = _flat(kernel(**args))
    params = inspect.signature(plain).parameters
    exp = _flat(plain(**{k: v for k, v in args.items() if k in params}))
    check(len(got) == len(exp), f"{what}: {len(got)} outputs vs {len(exp)}")
    rows = None
    if name == "merge_scatter":       # rows no run covers are unspecified without out_rows
        rows = args["out_rows"] or int((args["keys"] >= 0).sum())
    err = 0.0
    for i, (g, e) in enumerate(zip(got, exp)):
        check((g is None) == (e is None), f"{what}: output {i} missing")
        if g is None:
            continue
        if rows is not None:
            g, e = g[:rows], e[:rows]
        if g.is_floating_point() and name in ("onehot_groupby_aggregate", "bucket_aggregate"):
            err = max(err, same(g, e, f"{what} output {i}"))
        else:
            err = max(err, same_bits(g, e, f"{what} output {i}"))
    return err


def run_replayed(what, q, run, wrappers, plains, calls, needs=None):
    """Runs one query alone, every launch count at 0 before it, with every
    call of its kernels (``needs``, by default ``TPCH_NEEDS[q]``) recorded;
    checks that it launched exactly those kernels, then replays each
    recorded call on the card against its plain version at the shapes the
    query gave it, adding a row for each to ``calls`` by kernel.  Returns
    the launches."""
    needs = TPCH_NEEDS[q] if needs is None else needs
    for w in wrappers.values():
        w.launches = 0
    with KernelRecorder(wrappers, needs) as rec:
        run()
        torch.cuda.synchronize()
    launched = {k: w.launches for k, w in wrappers.items() if w.launches}
    check(sorted(launched) == sorted(needs), f"{what} launched {launched}, expected {needs}")
    for i, (name, args) in enumerate(rec.calls):   # at the shapes q gave it
        call = f"{what} call {i} of {name}"
        err = replay_check(wrappers, plains, name, args, call)
        params = inspect.signature(plains[name]).parameters
        row = dict(query=q, call=i, args=_describe(args), max_abs_err=err,
                   ms=device_ms(lambda: wrappers[name](**args)),
                   plain_ms=device_ms(lambda: plains[name](**{
                       k: v for k, v in args.items() if k in params})))
        calls.setdefault(name, []).append(row)
        log(f"phase 3 {call} agrees with its plain version: {json.dumps(row)}")
    replayed = sorted({name for name, _ in rec.calls})
    check(replayed == sorted(needs), f"{what}: replayed {replayed}")
    rec.calls.clear()
    torch.cuda.empty_cache()
    return launched


def tpch_phase(dev, smi, wrappers, drive, plains, strings, nested, ops, io, part, directory,
               spmd):
    """The nine TPC-H queries at SF10 (the main path) and SF1, and at SF10
    the string and temporal requests over lineitem (into ``strings``), the
    decimal ones (into ``nested``), the resample, window, as-of and
    day-unit ones (into ``ops``), the Parquet files (into ``io``), the
    partitioned executor over a Parquet dataset (into ``part``) and the
    queries over the mesh of ``spmd`` = (mesh, accumulator)."""
    from cudf_tpu_torch.models import tpch

    by_query, tpch_calls = {}, {}
    for scale in TPCH_SCALES:
        t0 = time.perf_counter()
        tables = tpch.generate_device(scale, seed=SEED, device=dev)
        torch.cuda.synchronize()
        n_li = len(tables["lineitem"])
        log(f"phase 4 TPC-H SF{scale}: {n_li} lineitem, {len(tables['orders'])} orders, "
            f"{len(tables['part'])} parts drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s")

        def run_all():
            return {q: fn(tables) for q, fn in tpch.QUERIES.items()}

        results = drive("tpch", run_all) if scale == TPCH_SCALES[0] else run_all()
        for q, res in results.items():
            err = check_tpch(q, res, tpch.PLAIN[q](tables))
            log(f"phase 4 TPC-H SF{scale} {q} agrees with plain torch, max abs err {err}")
        del results
        if scale == TPCH_SCALES[0]:
            for q, fn in tpch.QUERIES.items():     # alone, every count at 0 before
                by_query[q] = run_replayed(f"TPC-H SF{scale} {q}", q, lambda: fn(tables),
                                           wrappers, plains, tpch_calls)
            check(not by_query["q1"] and not by_query["q6"], "TPC-H q1 or q6 launched A-H")
            log(f"phase 4 TPC-H SF{scale} launches by query: {by_query}")
            for q in ("q1", "q3", "q9"):
                log(f"phase 4 TPC-H {q} torch.profiler split: " + json.dumps(
                    {f"tpch_sf10_{q}_profile": profile_split(lambda: tpch.QUERIES[q](tables)),
                     "card": smi}))
            log("phase 4 TPC-H SF10 join parts: " + json.dumps(
                dict(tpch_join_parts(tables), card=smi)))
            frame_by_query, frame_calls, frame_times = tpch_frame_phase(
                tables, smi, wrappers, drive, plains)
            over_rows = over_phase(tables, smi)
            strings_dt_phase("lineitem", {"lineitem": tables["lineitem"]}, smi, wrappers,
                             drive, plains, strings)
            money = {"lineitem": tables["lineitem"]}
            kept = nested_phase("lineitem", money, smi, wrappers, drive, plains, nested)
            nested[2].update(nested_lineitem_checks(money, kept, smi))
            del kept, money
            torch.cuda.empty_cache()
            ops_windows_phase("lineitem", {"lineitem": tables["lineitem"]}, smi, wrappers,
                              drive, plains, ops)
            torch.cuda.empty_cache()
            io[2]["tpch_sf10"] = io_tpch_phase(tables, smi, wrappers, drive, plains, io,
                                               directory)
            partitioned_tpch_phase(tables, smi, wrappers, drive, plains, part, directory)
            distributed_phase("tpch", {"tpch": tables}, smi, wrappers, drive, spmd[0],
                              spmd[1])
        for q, fn in tpch.QUERIES.items():
            ms = device_ms(lambda: fn(tables))
            plain = device_ms(lambda: tpch.PLAIN[q](tables))
            log(f"phase 5 TPC-H SF{scale} {q}: {ms:.3f} ms = {n_li / ms * 1e3:.4g} lineitem "
                f"rows/s; plain torch {plain:.3f} ms = {n_li / plain * 1e3:.4g} rows/s [{smi}]")
            torch.cuda.empty_cache()
        del tables
        torch.cuda.empty_cache()
    return by_query, tpch_calls, frame_by_query, frame_calls, frame_times, over_rows


def tpch_join_parts(tables):
    """ms of two parts of the join queries at SF10, on the queries' own
    inputs: q3's (and q10's) attempt of the multi tier with lineitem as
    the build side, which fails on fan-out before the swapped build runs;
    q4's semi join against the late lineitems, and the sort of their keys
    inside it."""
    from cudf_tpu_torch.engine import col, from_dataframe, lit
    from cudf_tpu_torch.models import tpch
    from cudf_tpu_torch.ops import join

    li, o, c = tables["lineitem"], tables["orders"], tables["customer"]
    q3_orders = (from_dataframe(c).filter(col("c_mktsegment") == lit("BUILDING"))
                 .join(from_dataframe(o), left_on="c_custkey", right_on="o_custkey")
                 .filter(col("o_orderdate") < lit(tpch.Q3_CUTOFF)).collect())
    ok, lk = q3_orders._table["o_orderkey"], li._table["l_orderkey"]
    check(join._try_radix_inner(ok, lk) is None, "q3: the multi tier served lineitem's build")
    lo, hi = tpch.Q4_RANGE
    q4_orders = from_dataframe(o).filter(
        (col("o_orderdate") >= lit(lo)) & (col("o_orderdate") < lit(hi))).collect()
    late = from_dataframe(li).filter(col("l_commitdate") < col("l_receiptdate")).collect()
    qk, late_k = q4_orders._table["o_orderkey"], late._table["l_orderkey"]
    return {"q3_probe_rows": ok.length, "q3_multi_tier_attempt_ms": device_ms(
                lambda: join._try_radix_inner(ok, lk)),
            "q3_swapped_build_ms": device_ms(lambda: join._try_radix_inner(lk, ok, False)),
            "q4_orders": qk.length, "q4_late_lineitems": late_k.length,
            "q4_semi_join_ms": device_ms(lambda: join.semi_join([qk], [late_k], False)),
            "q4_sort_of_late_keys_ms": device_ms(
                lambda: torch.sort(late_k.data, stable=True))}


# ----------------------------------------------------------------------
# TPC-H through the pandas API (the slice's main path), Over, and the
# column primitives at G1 scale with nulls
# ----------------------------------------------------------------------

def tpch_frame_phase(tables, smi, wrappers, drive, plains):
    """The nine queries of ``tpch.FRAME_QUERIES`` (pandas' code over the
    port's DataFrames) at SF10: each answer equal to the LazyFrame
    query's and the plain version's, each alone launching exactly
    ``TPCH_NEEDS``' kernels, whose every call is replayed against its
    plain version at the shapes the frame form gives it (they differ from
    the LazyFrame form's: the joins run in another order), each timed
    beside both; profiles of q1 and q3.  Returns the launches by query,
    the replayed calls by kernel and the times."""
    from cudf_tpu_torch.models import tpch

    n_li = len(tables["lineitem"])
    results = drive("tpch_frame", lambda: {q: fn(tables)
                                           for q, fn in tpch.FRAME_QUERIES.items()})
    for q, res in results.items():
        got = tpch.answer(q, res)
        err = agree(f"TPC-H frame {q} vs plain", got, tpch.PLAIN[q](tables))
        agree(f"TPC-H frame {q} vs LazyFrame", got, tpch.answer(q, tpch.QUERIES[q](tables)))
        log(f"phase 4 TPC-H frame SF10 {q} agrees with its LazyFrame form and plain torch, "
            f"max abs err {err}")
    del results
    torch.cuda.empty_cache()
    by_query, times, calls = {}, {}, {}
    for q, fn in tpch.FRAME_QUERIES.items():      # alone, every count at 0 before
        by_query[q] = run_replayed(f"TPC-H frame SF10 {q}", q, lambda: fn(tables),
                                   wrappers, plains, calls)
    log(f"phase 4 TPC-H frame SF10 launches by query: {by_query}")
    for q in ("q1", "q3"):
        log(f"phase 4 TPC-H frame {q} torch.profiler split: " + json.dumps(
            {f"tpch_frame_sf10_{q}_profile": profile_split(
                lambda: tpch.FRAME_QUERIES[q](tables)), "card": smi}))
    for q, fn in tpch.FRAME_QUERIES.items():
        row = {"frame_ms": device_ms(lambda: fn(tables)),
               "lazy_ms": device_ms(lambda: tpch.QUERIES[q](tables)),
               "plain_ms": device_ms(lambda: tpch.PLAIN[q](tables))}
        times[q] = row
        log(f"phase 5 TPC-H frame SF10 {q}: {row['frame_ms']:.3f} ms = "
            f"{n_li / row['frame_ms'] * 1e3:.4g} lineitem rows/s; LazyFrame "
            f"{row['lazy_ms']:.3f} ms; plain torch {row['plain_ms']:.3f} ms [{smi}]")
        torch.cuda.empty_cache()
    return by_query, calls, times


def over_phase(tables, smi):
    """``agg().over(keys)`` at SF10 over the 6e7-row lineitem: q17's
    per-part mean quantity (2e6 partitions) and the extended price summed
    over returnflag, linestatus (6 partitions), each against a plain
    PyTorch index_add_ / bincount and gather written apart from the port."""
    from cudf_tpu_torch.engine import col, from_dataframe

    li = tables["lineitem"]
    t = li._table
    lf = from_dataframe(li)
    part = lambda: lf.with_columns(col("l_quantity").mean().over("l_partkey")  # noqa: E731
                                   .alias("avg_qty")).collect()
    flags = lambda: lf.with_columns(  # noqa: E731
        col("l_extendedprice").sum().over("l_returnflag", "l_linestatus")
        .alias("flag_price")).collect()

    def plain_part():
        k = t["l_partkey"].data.long()
        q = t["l_quantity"].data
        g = int(k.max()) + 1
        s = torch.zeros(g, dtype=torch.float64, device=q.device).index_add_(0, k, q)
        c = torch.bincount(k, minlength=g)
        return (s / c)[k]

    def plain_flags():
        rf, ls = t["l_returnflag"], t["l_linestatus"]
        k = rf.data.long() * ls.keys.length + ls.data.long()
        s = torch.bincount(k, weights=t["l_extendedprice"].data,
                           minlength=rf.keys.length * ls.keys.length)
        return s[k]

    rows = {}
    for name, fn, plain in (("q17_avg_qty_over_partkey", part, plain_part),
                            ("price_over_flag_status", flags, plain_flags)):
        out = fn()._table
        got = out[out.names[-1]]
        check(got.validity is None or bool(got.validity.all()), f"Over {name}: nulls")
        err = same(got.data, plain(), f"Over {name}", float_rtol=1e-9)
        del out, got
        rows[name] = {"max_abs_err": err, "ms": device_ms(fn), "plain_ms": device_ms(plain),
                      "rows": len(li)}
        log(f"phase 4 Over {name} agrees with plain torch: {json.dumps(rows[name])} [{smi}]")
        torch.cuda.empty_cache()
    return rows


def g1_nulls_series(ct, dev, gen, n):
    """G1_1e8_1e2_5_0's shape (groupby-datagen.R with 5% NA): n rows of
    id4 (1..100), id6 (1..1e6), v1 (1..5) and v3 (U[0, 100)), each null
    in 5% of rows."""
    from cudf_tpu_torch.core import dtypes as dt
    from cudf_tpu_torch.core.column import Column

    def valid():
        return torch.rand(n, generator=gen, device=dev) >= 0.05

    def ints(hi):
        return Column(dt.INT32, n, torch.randint(1, hi + 1, (n,), generator=gen, device=dev,
                                                 dtype=torch.int32), valid())

    v3 = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) * 100
    return ct.DataFrame({"id4": ints(K_LOW), "id6": ints(K_HIGH), "v1": ints(5),
                         "v3": Column(dt.FLOAT64, n, v3, valid())})


def _filled(c, fill):
    return torch.where(c.validity, c.data, torch.tensor(fill, dtype=c.data.dtype,
                                                        device=c.device))


def _plain_ffill(c):
    pos = torch.arange(c.length, device=c.device)
    last = torch.cummax(torch.where(c.validity, pos, -1), 0).values
    return c.data[last.clamp(min=0)], last >= 0


def _plain_value_counts(c):
    """(keys, counts) of the valid rows: by first appearance, then stably
    by count, descending."""
    k = c.data.long()[c.validity]
    counts = torch.bincount(k)
    pos = torch.arange(k.shape[0], device=k.device)
    first = torch.full_like(counts, k.shape[0]).scatter_reduce_(0, k, pos, "amin")
    keys = torch.nonzero(counts).squeeze(1)
    keys = keys[torch.argsort(first[keys], stable=True)]
    keys = keys[torch.argsort(counts[keys], descending=True, stable=True)]
    return keys, counts[keys]


def primitives_phase(ct, dev, gen, smi):
    """The column primitives under the pandas API at 1e8 G1 rows with 5%
    nulls, each held against a plain PyTorch expression on the card and
    timed; ops.scan.ewm_mean at 1e7 rows held to the same call on the CPU."""
    from cudf_tpu_torch.ops import scan

    df = g1_nulls_series(ct, dev, gen, N)
    t = df._table
    v3c, v1c, id4c, id6c = t["v3"], t["v1"], t["id4"], t["id6"]
    v3, v1, id4, id6 = df["v3"], df["v1"], df["id4"], df["id6"]
    inf = torch.iinfo(torch.int32)
    nulls = ~v3c.validity

    def col(s):
        return s._column

    def data_valid(s):
        c = col(s)
        return c.data, c.validity

    def shifted(c):
        data = torch.cat([c.data.new_zeros(1), c.data[:-1]])
        valid = torch.cat([c.validity.new_zeros(1), c.validity[:-1]])
        return data, valid

    def vc_check(s):
        keys, counts = _plain_value_counts(id4c)
        return (s._index.column().data.long(), s._column.data), (keys, counts)

    m = v3 > 50.0
    a, b = v3[m], v1[m]                        # two indexes of one set of labels
    cases = {
        "fillna(0)": (lambda: v3.fillna(0.0), lambda: (_filled(v3c, 0.0), None)),
        "ffill": (lambda: v3.ffill(), lambda: _plain_ffill(v3c)),
        "bfill": (lambda: v3.bfill(), lambda: tuple(
            x.flip(0) for x in _plain_ffill(type(v3c)(v3c.dtype, N, v3c.data.flip(0),
                                                      v3c.validity.flip(0))))),
        "dropna": (lambda: df.dropna()["v3"], lambda: (v3c.data[
            v3c.validity & v1c.validity & id4c.validity & id6c.validity], None)),
        "isna().sum()": (lambda: v3.isna().sum(), lambda: int(nulls.sum())),
        "cumsum": (lambda: v3.cumsum(), lambda: (torch.cumsum(_filled(v3c, 0.0), 0),
                                                 v3c.validity)),
        "cummax": (lambda: v1.cummax(), lambda: (torch.cummax(_filled(v1c, inf.min), 0).values,
                                                 v1c.validity)),
        "shift(1)": (lambda: v3.shift(1), lambda: shifted(v3c)),
        "diff": (lambda: v3.diff(), lambda: (v3c.data - shifted(v3c)[0],
                                             v3c.validity & shifted(v3c)[1])),
        "clip": (lambda: v3.clip(10.0, 90.0), lambda: (v3c.data.clamp(10.0, 90.0),
                                                       v3c.validity)),
        "where": (lambda: v3.where(v3 > 50.0, 0.0), lambda: (
            torch.where(v3c.validity & (v3c.data > 50.0), v3c.data, 0.0), None)),
        "isin": (lambda: id4.isin([1, 2, 3]), lambda: (
            ((id4c.data >= 1) & (id4c.data <= 3)) & id4c.validity, None)),
        "astype(float64)": (lambda: v1.astype("float64"), lambda: (v1c.data.double(),
                                                                   v1c.validity)),
        "replace": (lambda: v1.replace({1: 100}), lambda: (
            torch.where(v1c.data == 1, 100, v1c.data).int(), v1c.validity)),
        "value_counts(id4)": (lambda: id4.value_counts(), None),
        "nunique(id6)": (lambda: id6.nunique(), lambda: int(
            (torch.bincount(id6c.data.long()[id6c.validity]) > 0).sum())),
        "astype(category)": (lambda: id4.astype("category"), lambda: torch.unique(
            id4c.data[id4c.validity], sorted=True, return_inverse=True)),
        "v3 + v1 (one index)": (lambda: v3 + v1, lambda: (v3c.data + v1c.data,
                                                          v3c.validity & v1c.validity)),
        "v3[m] + v1[m] (two indexes, one set of labels)": (
            lambda: a + b, lambda: (a._column.data + b._column.data,
                                    a._column.validity & b._column.validity)),
    }
    rows = {}
    for name, (fn, plain) in cases.items():
        res = fn()
        if name == "value_counts(id4)":
            (gk, gc), (ek, ec) = vc_check(res)
            err = same(gk, ek, name) + same(gc, ec, name)
            plain = lambda: _plain_value_counts(id4c)  # noqa: E731
        elif name == "astype(category)":
            c = col(res)
            decoded = c.keys.data[c.data.long()]
            check(torch.equal(c.validity, id4c.validity), f"{name}: validity")
            err = same(torch.where(c.validity, decoded, 0), _filled(id4c, 0), name)
        elif isinstance(res, ct.Series):
            got_d, got_v = data_valid(res)
            exp_d, exp_v = plain()
            if exp_v is None:
                check(got_v is None or bool(got_v.all()), f"{name}: unexpected nulls")
                err = same(got_d, exp_d, name, float_rtol=1e-9)
            else:
                check(torch.equal(got_v, exp_v), f"{name}: validity differs")
                err = same(torch.where(got_v, got_d, 0), torch.where(exp_v, exp_d, 0), name,
                           float_rtol=1e-9)
        else:
            check(res == plain(), f"{name}: {res} vs {plain()}")
            err = 0.0
        del res
        rows[name] = {"max_abs_err": err, "ms": device_ms(fn), "plain_ms": device_ms(plain)}
        log(f"phase 4 primitive {name} at 1e8 G1 rows with 5% nulls agrees with plain torch: "
            f"{json.dumps(rows[name])} [{smi}]")
        torch.cuda.empty_cache()
    del df, t, v3c, v1c, id4c, id6c, v3, v1, id4, id6, a, b, m, cases
    torch.cuda.empty_cache()
    x = torch.rand(N // 10, generator=gen, device=dev, dtype=torch.float64)
    valid = torch.rand(N // 10, generator=gen, device=dev) >= 0.05
    from cudf_tpu_torch.core import dtypes as dt
    from cudf_tpu_torch.core.column import Column

    for adjust in (True, False):
        c = Column(dt.FLOAT64, x.shape[0], x, valid)
        got = scan.ewm_mean(c, 0.1, adjust=adjust)
        exp = scan.ewm_mean(Column(dt.FLOAT64, x.shape[0], x.cpu(), valid.cpu()), 0.1,
                            adjust=adjust)
        check(torch.equal(got.validity.cpu(), exp.validity), "ewm_mean validity")
        err = same(got.data.cpu(), exp.data, f"ewm_mean adjust={adjust}", float_rtol=1e-9)
        row = {"max_abs_err": err, "ms": device_ms(lambda: scan.ewm_mean(c, 0.1, adjust)),
               "rows": x.shape[0]}
        rows[f"ewm_mean adjust={adjust}"] = row
        log(f"phase 4 ops.scan.ewm_mean adjust={adjust} at 1e7 rows on the card agrees with "
            f"the CPU: {json.dumps(row)} [{smi}]")
    return rows



# ----------------------------------------------------------------------
# the frame API: join in J1's form, reshapes and UDFs over G1, missing data
# ----------------------------------------------------------------------

def check_frame_api(name, got, exp, rtol):
    """A request's answer against its plain version's: the same keys;
    integers, bools and validity exact, floats at the request's rtol
    (0: exact); returns the max abs error."""
    check(list(got) == list(exp), f"frame API {name}: {list(got)} vs {list(exp)}")
    return max(same(got[k], exp[k], f"frame API {name} {k}", float_rtol=rtol) for k in exp)


def launch_set(wrappers, run):
    """The kernels one run launches, every count at 0 before it."""
    for w in wrappers.values():
        w.launches = 0
    run()
    torch.cuda.synchronize()
    return {k: w.launches for k, w in wrappers.items() if w.launches}


def frame_api_phase(group, frames, smi, wrappers, drive, plains):
    """The frame API's requests on one table (``models/frame_api.py``
    ``GROUPS[group]``): all of them as one main path, each answer against
    its plain version; then each alone, every count at 0 before it,
    launching exactly its ``NEEDS`` (every kernel call replayed against
    its plain version), a UDF taking its ``ROUTE`` and no other, an inner
    join launching what the same merge launches; then each timed beside
    its plain version.  Returns the launches by request, the replayed
    calls by kernel and the times."""
    from cudf_tpu_torch.frame.series import UDF_ROUTES
    from cudf_tpu_torch.models import frame_api as fa

    names = fa.GROUPS[group]
    results = drive(f"frame_api_{group}", lambda: {n: fa.REQUESTS[n](frames) for n in names})
    errs = {}
    for n in names:
        errs[n] = check_frame_api(n, fa.ANSWERS[n](results.pop(n), frames), fa.PLAIN[n](frames),
                                  fa.RTOL[n])
        torch.cuda.empty_cache()
    log(f"phase 4 frame API {group}: every request equals its plain version, max abs err "
        f"{json.dumps(errs)}")
    by_request, calls, times = {}, {}, {}
    for n in names:
        run = (lambda n=n: fa.REQUESTS[n](frames))
        before = dict(UDF_ROUTES)
        by_request[n] = run_replayed(f"frame API {n}", n, run, wrappers, plains, calls,
                                     needs=fa.NEEDS[n])
        took = {k: UDF_ROUTES[k] - before[k] for k in before}
        if n in fa.ROUTE:
            check(took == {k: int(k == fa.ROUTE[n]) for k in took},
                  f"frame API {n}: UDF routes {took}, expected {fa.ROUTE[n]}")
        else:
            check(not any(took.values()), f"frame API {n}: UDF routes {took}")
        if n.startswith("join_inner") or n == "join_index_medium":
            size = n.rsplit("_", 1)[1]
            merged = launch_set(wrappers, lambda: frames[f"fact_{size}"].merge(
                frames[f"dim_{size}"], on="id"))
            check(merged == by_request[n], f"frame API {n} launched {by_request[n]}, the same "
                                           f"merge {merged}")
        row = {"ms": device_ms(run), "plain_ms": device_ms(lambda n=n: fa.PLAIN[n](frames)),
               "max_abs_err": errs[n], "launches": by_request[n], "udf_routes": took}
        times[n] = row
        log(f"phase 4/5 frame API {n}: {json.dumps(row)} [{smi}]")
        torch.cuda.empty_cache()
    return by_request, calls, times


def add_frame_api(acc, out):
    """One frame API phase's (launches by request, replayed calls by
    kernel, times) added to the run's."""
    acc[0].update(out[0])
    for name, rows in out[1].items():
        acc[1].setdefault(name, []).extend(rows)
    acc[2].update(out[2])


def count_syncs(run):
    """The host syncs one run makes, as torch's sync debug mode reports
    them (a warning each)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def strings_dt_phase(group, frames, smi, wrappers, drive, plains, acc):
    """The string and temporal requests of one table
    (``models/strings_dt.py`` ``GROUPS[group]``): all of them as one main
    path, each answer against its plain version; then each alone, every
    count at 0 before it, launching exactly its ``NEEDS`` (every kernel
    call replayed against its plain version) and taking the device route
    (``STRING_ROUTES["host"]`` unmoved); its host syncs counted; then each
    timed beside its plain version.  Adds (launches, calls, times) by
    request to ``acc``."""
    from cudf_tpu_torch.models import strings_dt as sd
    from cudf_tpu_torch.ops.strings import STRING_ROUTES

    host = STRING_ROUTES["host"]
    names = sd.GROUPS[group]
    sd.prepare(frames)
    results = drive(f"strings_{group}", lambda: {n: sd.REQUESTS[n](frames) for n in names})
    errs = {}
    for n in names:
        errs[n] = check_frame_api(n, sd.ANSWERS[n](results.pop(n), frames), sd.PLAIN[n](frames),
                                  sd.RTOL[n])
    check(STRING_ROUTES["host"] == host, f"strings {group}: a request took the host route")
    log(f"phase 4 strings {group}: every request equals its plain version, max abs err "
        f"{json.dumps(errs)}")
    torch.cuda.empty_cache()
    for n in names:
        run = (lambda n=n: sd.REQUESTS[n](frames))
        before = dict(STRING_ROUTES)
        acc[0][n] = run_replayed(f"strings {n}", n, run, wrappers, plains, acc[1],
                                 needs=sd.NEEDS[n])
        took = {k: STRING_ROUTES[k] - before[k] for k in before}
        check(took["host"] == 0, f"strings {n}: routes {took}, expected {sd.ROUTE[n]}")
        row = {"ms": device_ms(run, reps=3),
               "plain_ms": device_ms(lambda n=n: sd.PLAIN[n](frames), reps=3),
               "host_syncs": count_syncs(run), "max_abs_err": errs[n],
               "launches": acc[0][n]}
        acc[2][n] = row
        log(f"phase 4/5 strings {n}: {json.dumps(row)} [{smi}]")
        torch.cuda.empty_cache()
    check(STRING_ROUTES["host"] == host, f"strings {group}: a request took the host route")


def nested_phase(group, frames, smi, wrappers, drive, plains, acc):
    """The LIST, STRUCT and decimal requests of one table
    (``models/nested.py`` ``GROUPS[group]``): all of them as one main path,
    each answer against its plain version (exact); then each alone, every
    count at 0 before it, launching exactly its ``NEEDS`` (none) and no
    host route, its host syncs counted, timed beside its plain version.
    Adds (launches, calls, times) by request to ``acc``; returns the
    results the group's own checks read."""
    from cudf_tpu_torch.models import nested
    from cudf_tpu_torch.ops._utils import HOST_ROUTES
    from cudf_tpu_torch.ops.strings import STRING_ROUTES

    routes = (dict(STRING_ROUTES), dict(HOST_ROUTES))
    names = nested.GROUPS[group]
    results = drive(f"nested_{group}", lambda: {n: nested.REQUESTS[n](frames) for n in names})
    errs, kept = {}, {}
    for n in names:
        res = results.pop(n)
        if n in ("topk2_id6", "q1_charge"):
            kept[n] = res
        errs[n] = check_frame_api(n, nested.ANSWERS[n](res, frames), nested.PLAIN[n](frames),
                                  nested.RTOL[n])
        del res
        torch.cuda.empty_cache()
    check(STRING_ROUTES["host"] == routes[0]["host"] and HOST_ROUTES == routes[1],
          f"nested {group}: a request took a host route ({STRING_ROUTES}, {HOST_ROUTES})")
    log(f"phase 4 nested {group}: every request equals its plain version, max abs err "
        f"{json.dumps(errs)}")
    for n in names:
        run = (lambda n=n: nested.REQUESTS[n](frames))
        before = dict(STRING_ROUTES)
        acc[0][n] = run_replayed(f"nested {n}", n, run, wrappers, plains, acc[1],
                                 needs=nested.NEEDS[n])
        check(STRING_ROUTES["host"] == before["host"] and HOST_ROUTES == routes[1],
              f"nested {n}: took a host route")
        row = {"ms": device_ms(run, reps=3),
               "plain_ms": device_ms(lambda n=n: nested.PLAIN[n](frames), reps=3),
               "host_syncs": count_syncs(run), "max_abs_err": errs[n],
               "launches": acc[0][n]}
        acc[2][n] = row
        log(f"phase 4/5 nested {n}: {json.dumps(row)} [{smi}]")
        torch.cuda.empty_cache()
    return kept


def nested_g1_checks(df, kept):
    """q8 through group_topk must hold the sort-tier q8's (id6, v3) pairs."""
    rows, cols = plain_q8(df)
    top = kept["topk2_id6"]
    got = torch.stack([top.index.column(top.device).data.double(), top._column.data], 1)
    exp = torch.stack([cols["id6"].double(), cols["v3"]], 1)
    order_g = torch.sort(got[:, 1], stable=True).indices
    order_g = order_g[torch.sort(got[order_g, 0], stable=True).indices]
    order_e = torch.sort(exp[:, 1], stable=True).indices
    order_e = order_e[torch.sort(exp[order_e, 0], stable=True).indices]
    same(got[order_g], exp[order_e], "nested q8 by group_topk vs the sort tier's q8",
         float_rtol=0.0)
    log(f"phase 4 nested q8: group_topk(k=2) exploded holds the sort tier's {rows.numel()} "
        "(id6, v3) pairs exactly")


def nested_lineitem_checks(frames, kept, smi):
    """The float64 q6 mask beside the decimal one, the Arrow round trip of
    charge (where pyarrow is installed) and the two-limb product past
    2^63 on 1e7 rows."""
    import importlib.util

    from cudf_tpu_torch.core.column import Column
    from cudf_tpu_torch.models import nested
    from cudf_tpu_torch.ops import decimal128 as d128

    exact = nested.PLAIN["q6_mask"](frames)["values"]
    differ = int((nested.float_q6_mask(frames) != exact).sum())
    log(f"phase 4 nested q6: the decimal mask selects {int(exact.sum())} rows; the float64 "
        f"mask differs from it in {differ} rows")
    charge = kept["q1_charge"]
    if importlib.util.find_spec("pyarrow") is None:
        log("phase 4 nested arrow: pyarrow is not installed on this machine; the decimal128 "
            "round trip of charge is left to the CPU tests")
    else:
        t0 = time.perf_counter()
        back = Column.from_arrow(charge._column.to_arrow(), device=charge.device)
        check(back.dtype.scale == -6 and not back.children and
              torch.equal(back.data, charge._column.data), "nested arrow round trip of charge")
        log(f"phase 4 nested arrow: charge through pa.decimal128(38, 6) and back, equal, "
            f"{time.perf_counter() - t0:.3f} s on the host")
    rows = min(10_000_000, len(charge))
    a, b, prod = nested.decimal128_product(charge, rows)
    hi, lo = d128.limbs(prod)
    check(torch.equal(lo, a.data * b.data), "decimal128 product: low limb")
    passed = int((hi != torch.where(lo < 0, -1, 0)).sum())
    check(passed > 0, "decimal128 product: no product passed 2^63")
    pick = torch.randperm(rows, generator=torch.Generator(device=lo.device).manual_seed(SEED),
                          device=lo.device)[:min(10_000, rows)]
    xs, ys = a.data[pick].tolist(), b.data[pick].tolist()
    got = d128.to_ints128(d128.make_decimal128(hi[pick], lo[pick], prod.dtype.scale))
    check(got == [x * y for x, y in zip(xs, ys)], "decimal128 product vs Python ints")
    row = {"ms": device_ms(lambda: d128.binary128(a, b, "mul"), reps=3),
           "plain_ms": device_ms(lambda: a.data * b.data, reps=3),
           "plain": "the int64 product (its low limb)", "products_past_2^63": passed,
           "host_syncs": count_syncs(lambda: d128.binary128(a, b, "mul"))}
    log(f"phase 4/5 nested decimal128_mul_1e7: {json.dumps(row)} [{smi}]")
    return {"decimal128_mul_1e7": row, "q6_float_mask_rows_differing": differ}


# ----------------------------------------------------------------------
# ops and windows (models/ops_windows.py)
# ----------------------------------------------------------------------

def close_or_nan(name, got, exp, rtol):
    """A request's answer against its plain version's: the same keys;
    integers, bools and validity exact; floats NaN where the plain
    version's are and within rtol (0: exact) elsewhere.  Returns the max
    abs error."""
    check(list(got) == list(exp), f"ops/windows {name}: {list(got)} vs {list(exp)}")
    err = 0.0
    for k in exp:
        g, e = got[k], exp[k]
        check(g.dtype == e.dtype and g.shape == e.shape,
              f"ops/windows {name} {k}: {g.dtype}{list(g.shape)} vs {e.dtype}{list(e.shape)}")
        if not g.is_floating_point():
            check(torch.equal(g, e), f"ops/windows {name} {k}: differs")
            continue
        nan = torch.isnan(e)
        check(torch.equal(torch.isnan(g), nan), f"ops/windows {name} {k}: NaN rows differ")
        check(torch.allclose(g[~nan], e[~nan], rtol=rtol, atol=0.0),
              f"ops/windows {name} {k}: differs")
        err = max(err, max_abs_err(g[~nan], e[~nan]))
    return err


def once_ms(fn):
    """One run's device time in ms (a host route is timed once)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def ops_windows_phase(group, frames, smi, wrappers, drive, plains, acc):
    """The requests of one table (``models/ops_windows.py``
    ``GROUPS[group]``): all of them as one main path, each answer held
    against its plain version inside it and let go; then each alone, every
    count at 0 before it, launching exactly its ``NEEDS`` (every kernel
    call replayed against its plain version) and taking its ``ROUTE`` and
    no other; its host syncs counted; a device request timed beside its
    plain version, a host request once.  A ``Tracer`` range wraps each
    request; its summary is printed.  Adds (launches, calls, times) by
    request to ``acc``."""
    from cudf_tpu_torch.frame.series import UDF_ROUTES
    from cudf_tpu_torch.models import ops_windows as ow
    from cudf_tpu_torch.ops._utils import HOST_ROUTES
    from cudf_tpu_torch.ops.strings import STRING_ROUTES
    from cudf_tpu_torch.utils.tracing import enable_tracing

    names = ow.GROUPS[group]
    ow.prepare(frames)
    torch.cuda.synchronize()

    def routes():
        return {"string_host": STRING_ROUTES["host"], "host_routes": sum(HOST_ROUTES.values()),
                "udf_vmap": UDF_ROUTES["vmap"], "udf_host": UDF_ROUTES["host"]}

    def took(before, after):
        return {k: after[k] - before[k] for k in before if after[k] != before[k]}

    # the routes each kind moves (a host request's factories may count too)
    expected = {"device": set(), "vmap": {"udf_vmap"}, "host": {"host_routes"}}
    errs = {}
    with enable_tracing() as tracer:
        tracer.clear()

        def main_path():
            for n in names:
                with tracer.range(f"{group}/{n}"):
                    got = ow.ANSWERS[n](ow.REQUESTS[n](frames), frames)
                errs[n] = close_or_nan(n, got, ow.PLAIN[n](frames), ow.RTOL[n])
                del got
                torch.cuda.empty_cache()
        drive(f"ops_windows_{group}", main_path)
        log(f"phase 4 ops/windows {group}: every request equals its plain version, max abs "
            f"err {json.dumps(errs)}")
        for n in names:
            run = (lambda n=n: ow.REQUESTS[n](frames))
            before = routes()
            acc[0][n] = run_replayed(f"ops/windows {n}", n, run, wrappers, plains, acc[1],
                                     needs=ow.NEEDS[n])
            route = took(before, routes())
            check(set(route) == expected[ow.ROUTE[n]] and all(v > 0 for v in route.values())
                  and route.get("udf_vmap", 1) == 1,
                  f"ops/windows {n}: routes {route}, expected {ow.ROUTE[n]}")
            if ow.ROUTE[n] == "host":
                row = {"ms_once": once_ms(run), "plain_ms_once": once_ms(
                    lambda n=n: ow.PLAIN[n](frames)), "route": "host"}
            else:
                row = {"ms": device_ms(run, reps=3),
                       "plain_ms": device_ms(lambda n=n: ow.PLAIN[n](frames), reps=3),
                       "host_syncs": count_syncs(run), "route": ow.ROUTE[n]}
            row.update(max_abs_err=errs[n], launches=acc[0][n])
            acc[2][n] = row
            log(f"phase 4/5 ops/windows {n}: {json.dumps(row)} [{smi}]")
            torch.cuda.empty_cache()
        log(f"phase 4 ops/windows {group} tracer (host s by range): "
            + json.dumps(tracer.summary()))


def py_murmur3(data: bytes, seed: int = 0) -> int:
    """MurmurHash3_x86_32 as Appleby published it, over Python ints."""
    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF

    c1, c2, h = 0xCC9E2D51, 0x1B873593, seed & 0xFFFFFFFF
    full = len(data) // 4 * 4
    for i in range(0, full, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = rotl(k * c1 & 0xFFFFFFFF, 15) * c2 & 0xFFFFFFFF
        h = (rotl(h ^ k, 13) * 5 + 0xE6546B64) & 0xFFFFFFFF
    if len(data) > full:
        k = int.from_bytes(data[full:], "little")
        h ^= rotl(k * c1 & 0xFFFFFFFF, 15) * c2 & 0xFFFFFFFF
    h ^= len(data)
    h ^= h >> 16
    h = h * 0x85EBCA6B & 0xFFFFFFFF
    h ^= h >> 13
    h = h * 0xC2B2AE35 & 0xFFFFFFFF
    return h ^ (h >> 16)


def py_xxh64(data: bytes, seed: int = 0) -> int:
    """xxHash64 as Collet published it, over Python ints."""
    m = (1 << 64) - 1
    p1, p2, p3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    p4, p5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, lane):
        return rotl((acc + lane * p2) & m, 31) * p1 & m

    n, i = len(data), 0
    if n >= 32:
        v = [(seed + p1 + p2) & m, (seed + p2) & m, seed & m, (seed - p1) & m]
        while i + 32 <= n:
            v = [rnd(v[j], int.from_bytes(data[i + 8 * j:i + 8 * j + 8], "little"))
                 for j in range(4)]
            i += 32
        acc = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & m
        for vj in v:
            acc = ((acc ^ rnd(0, vj)) * p1 + p4) & m
    else:
        acc = (seed + p5) & m
    acc = (acc + n) & m
    while i + 8 <= n:
        acc = (rotl(acc ^ rnd(0, int.from_bytes(data[i:i + 8], "little")), 27) * p1 + p4) & m
        i += 8
    if i + 4 <= n:
        acc = (rotl(acc ^ (int.from_bytes(data[i:i + 4], "little") * p1 & m), 23) * p2
               + p3) & m
        i += 4
    while i < n:
        acc = rotl(acc ^ (data[i] * p5 & m), 11) * p1 & m
        i += 1
    acc ^= acc >> 33
    acc = acc * p2 & m
    acc ^= acc >> 29
    acc = acc * p3 & m
    return acc ^ (acc >> 32)


def ops_windows_g1_checks(frames, smi):
    """Beside the plain versions: both hashes on 1e4 sampled rows against
    the pure-Python algorithms; the t-digest's estimates at 0.01, 0.5 and
    0.99 within 0.5 of each id1's exact quantiles (a sort), and the digest
    merged from 8 row partitions against the whole column's; each rolling
    statistic on 1e4 sampled rows against float64 numpy over the window
    recomputed on the host."""
    import numpy as np

    from cudf_tpu_torch.models import ops_windows as ow
    from cudf_tpu_torch.ops import tdigest

    g1 = frames["g1"]
    dev = g1.device
    pick = torch.randperm(N, generator=torch.Generator(device=dev).manual_seed(SEED),
                          device=dev)[:10_000].sort().values
    rows = pick.tolist()
    mm = ow.REQUESTS["hash_murmur3_id4_id6"](frames)._column.data.view(torch.int32)[pick]
    id4 = g1._table["id4"].data[pick].tolist()
    id6 = g1._table["id6"].data[pick].tolist()
    for got, a, b in zip(mm.tolist(), id4, id6):
        ha, hb = py_murmur3(a.to_bytes(4, "little", signed=True)), \
            py_murmur3(b.to_bytes(4, "little", signed=True))
        exp = ha ^ ((hb + 0x9E3779B9 + (ha << 6 & 0xFFFFFFFF) + (ha >> 2)) & 0xFFFFFFFF)
        check(got & 0xFFFFFFFF == exp, "murmur3 vs the pure-Python algorithm")
    xx = ow.REQUESTS["hash_xxhash64_id3"](frames)._column.data.view(torch.int64)[pick].tolist()
    text = ow._matrix(frames["id3s"]._column)[pick].cpu().numpy()
    for got, row in zip(xx, text):
        check(got & ((1 << 64) - 1) == py_xxh64(row.tobytes()), "xxhash64 vs the algorithm")
    log("phase 4 ops/windows hashes: murmur3 of (id4, id6) and xxhash64 of id3 equal the "
        "pure-Python algorithms on 1e4 sampled rows")

    codes, v3 = g1._table["id1"].data.long(), g1._table["v3"].data
    x = v3.cpu().numpy()
    w = ow.WINDOW
    sample = [i for i in rows if i >= w - 1]
    stats = {"rolling_sum": np.sum, "rolling_mean": np.mean,
             "rolling_std": lambda a: np.std(a, ddof=1), "rolling_min": np.min,
             "rolling_max": np.max, "rolling_count": len}
    for name, fn in stats.items():
        got = ow.REQUESTS[name](frames)._column.data.cpu().numpy()
        exp = np.array([fn(x[i - w + 1:i + 1]) for i in sample], np.float64)
        check(np.allclose(got[sample], exp, rtol=1e-9, atol=0), f"{name} vs numpy on the host")
    off = (w - 1) // 2
    got = ow.REQUESTS["rolling_center_sum"](frames)._column.data.cpu().numpy()
    exp = np.array([x[max(i + 1 + off - w, 0):i + 1 + off].sum() for i in rows])
    check(np.allclose(got[rows], exp, rtol=1e-9, atol=0), "centred sum vs numpy on the host")
    log(f"phase 4 ops/windows rolling({w}): sum, mean, std, min, max, count and the centred "
        f"sum on 1e4 sampled rows within rtol 1e-9 of float64 numpy on the host")

    col = ow.REQUESTS["tdigest_id1"](frames)._column
    qs = [0.01, 0.5, 0.99]
    order = torch.argsort(v3, stable=True)
    order = order[torch.argsort(codes[order], stable=True)]
    sizes = torch.bincount(codes)
    starts = (torch.cumsum(sizes, 0) - sizes).tolist()
    worst = 0.0
    cent = col.children[0]
    offs = cent.offsets.tolist()
    means, weights = cent.children[0].children[0].data, cent.children[0].children[1].data
    mins, maxs = col.children[1].data.tolist(), col.children[2].data.tolist()
    for g in range(col.length):
        digest = tdigest.TDigest(means[offs[g]:offs[g + 1]], weights[offs[g]:offs[g + 1]],
                                 mins[g], maxs[g])
        est = tdigest.percentile_approx(digest, qs).data
        xs = v3[order[starts[g]:starts[g] + int(sizes[g])]]
        exact = torch.quantile(xs, torch.tensor(qs, dtype=torch.float64, device=dev))
        worst = max(worst, float((est - exact).abs().max()))
    check(worst < 0.5, f"t-digest estimates {worst} from the exact quantiles")
    whole = tdigest.build_tdigest(g1._table["v3"], ow.TDIGEST_DELTA)
    parts = [tdigest.build_tdigest(type(g1._table["v3"])(
        g1._table["v3"].dtype, N // 8, v3[i * N // 8:(i + 1) * N // 8]), ow.TDIGEST_DELTA)
        for i in range(8)]
    merged = tdigest.merge_tdigests(parts, ow.TDIGEST_DELTA)
    a, b = (tdigest.percentile_approx(d, qs).data for d in (whole, merged))
    check(float((a - b).abs().max()) < 0.5, "merged digest vs the whole column's")
    log(f"phase 4 ops/windows t-digest: 100 id1 digests' estimates at {qs} within "
        f"{worst:.4g} of the exact quantiles; 8 merged partitions' estimates "
        f"{[round(x, 4) for x in b.tolist()]} vs the whole column's "
        f"{[round(x, 4) for x in a.tolist()]} [{smi}]")


def ops_windows_j1_checks(frames, smi):
    """The bloom filter over J1 big: no false negatives (every fact row
    whose id is a dim id, and every dim id, may be present); the false
    positive rate beside (1 - e^(-k n / m))^k."""
    from cudf_tpu_torch.models import ops_windows as ow

    bloom, maybe = ow.REQUESTS["bloom_j1_big"](frames)
    dim_ids = frames["dim"]._table["id"]
    n_dim = dim_ids.length
    check(bool(bloom.maybe_contains([dim_ids]).all()), "bloom: a dim id was missed")
    ids = frames["fact"]._table["id"].data
    inside = ids <= n_dim                     # the dim's ids are a permutation of 1..n
    check(bool(maybe[inside].all()), "bloom: a false negative")
    fp = float(maybe[~inside].double().mean())
    expected = (1 - math.exp(-bloom.k * n_dim / bloom.m)) ** bloom.k
    log(f"phase 4 ops/windows bloom: 2^30 bits, k = 4, {n_dim} dim ids: no false negatives "
        f"over {int(inside.sum())} fact rows; false positive rate {fp:.6f} over "
        f"{int((~inside).sum())} absent ids, expected {expected:.6f}; fill ratio "
        f"{bloom.fill_ratio():.6f} [{smi}]")
    return {"false_positive_rate": fp, "expected": expected}


def frame_api_null_frames(ct, dev, gen):
    """G1_1e8_1e2_5_0's columns (id4, id6, v1, v3, each null in 5% of
    rows) with v2 (1..15, no nulls), and the Series of 1e6 distinct labels
    of that frame (values U[0, 100), 5% null) that ``update`` applies."""
    from cudf_tpu_torch.core import dtypes as dt
    from cudf_tpu_torch.core.column import Column
    from cudf_tpu_torch.frame.index import Index
    from cudf_tpu_torch.models.frame_api import UPDATE_ROWS

    nulls = g1_nulls_series(ct, dev, gen, N)
    nulls["v2"] = torch.randint(1, 16, (N,), generator=gen, device=dev, dtype=torch.int32)
    labels = torch.randperm(N, generator=gen, device=dev)[:UPDATE_ROWS]
    values = Column(dt.FLOAT64, UPDATE_ROWS,
                    torch.rand(UPDATE_ROWS, generator=gen, device=dev, dtype=torch.float64) * 100,
                    torch.rand(UPDATE_ROWS, generator=gen, device=dev) >= 0.05)
    return {"nulls": nulls, "update": ct.Series._from(values, Index(Column.from_tensor(labels)),
                                                      "v3")}


def wall_ms(fn, reps=REPS):
    """Median wall-clock ms of fn() over reps warm runs, each ended by a
    synchronize (a file read is host and device work)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def io_phase(group, frames, smi, wrappers, drive, plains, acc, models=None):
    """The requests of one group (``GROUPS[group]`` of ``models``,
    ``models/io_paths.py`` by default): all of them as one main path,
    each result held to its plain check; then each alone but the writes
    and ``ONCE``, every count at 0 before it, launching exactly its
    ``NEEDS`` (every kernel call replayed against its plain version) and
    never the pyarrow or pandas tier.  Adds (launches, calls, rows) by
    request to ``acc``; returns the main path's results by request."""
    from cudf_tpu_torch.io import IO_ROUTES
    from cudf_tpu_torch.models import io_paths

    iop = models or io_paths
    names = iop.GROUPS[group]
    errs, results = {}, {}

    def host_tiers():
        return IO_ROUTES["pyarrow"], IO_ROUTES["pandas"]

    def main_path():
        for n in names:
            before = host_tiers()
            t0 = time.perf_counter()
            res = iop.REQUESTS[n](frames)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            if n in iop.KEEP:
                frames[iop.KEEP[n]] = res
            errs[n] = iop.PLAIN[n](frames, res)
            check(host_tiers() == before, f"IO {n} took a host tier: {IO_ROUTES}")
            results[n] = {"first_s": first_s}
            log(f"phase 4 IO {n}: equals its plain check (max abs err {errs[n]}), first run "
                f"{first_s:.3f} s [{smi}]")
            del res
            torch.cuda.empty_cache()
    drive(f"io_{group}", main_path)
    for n in names:
        if n.endswith("_write") or n in getattr(iop, "ONCE", ()):
            acc[0][n] = {}
            acc[2][n] = dict(results[n], max_abs_err=errs[n], launches={})
            continue
        run = (lambda n=n: iop.REQUESTS[n](frames))
        acc[0][n] = run_replayed(f"IO {n}", n, run, wrappers, plains, acc[1],
                                 needs=iop.NEEDS[n])
        acc[2][n] = dict(results[n], max_abs_err=errs[n], launches=acc[0][n])
        torch.cuda.empty_cache()
    check(host_tiers() == (0, 0), f"IO routes {IO_ROUTES}: a host tier was taken")
    return results


def io_tpch_phase(tables, smi, wrappers, drive, plains, acc, directory):
    """TPC-H SF10 written to Parquet and queried from it (phase 4/5 of the
    file formats); the first IO phase, so it builds the host library."""
    import cudf_tpu_torch as ct
    from cudf_tpu_torch.engine import scan_parquet
    from cudf_tpu_torch.io import _native
    from cudf_tpu_torch.io import parquet_native as pn
    from cudf_tpu_torch.models import io_paths as iop
    from cudf_tpu_torch.models import tpch

    t0 = time.perf_counter()
    lib = _native.build()
    _native.lib()
    build_s = time.perf_counter() - t0
    log(f"phase 2 IO host library: {lib.relative_to(_native.BUILD_DIR.parent.parent)} built "
        f"from {_native.SOURCE.relative_to(_native.BUILD_DIR.parent.parent)} in {build_s:.2f} s "
        f"(g++ {' '.join(_native.CXX_FLAGS)}; {_native.BUILD_SECONDS:.2f} s compiling)")
    frames = {"dir": directory, "device": tables["lineitem"]._table.device}
    frames["tpch"] = dict(tables, lineitem=tables["lineitem"].sort_values(
        "l_shipdate").reset_index(drop=True))
    torch.cuda.synchronize()
    results = io_phase("tpch", frames, smi, wrappers, drive, plains, acc)
    size = sum(os.path.getsize(os.path.join(directory, f"{n}.parquet"))
               for n in ("lineitem", "orders", "part"))
    write_s = results["tpch_write"]["first_s"]
    log(f"phase 5 IO TPC-H SF10 write: lineitem, orders, part {size / 1e6:.1f} MB in "
        f"{write_s:.2f} s [{smi}]")
    rows = {"write_s": write_s, "file_mb": size / 1e6, "host_library_build_s": build_s}
    for q in ("q1", "q6", "q12", "q14"):
        ms_file = wall_ms(lambda q=q: iop.REQUESTS[f"tpch_{q}_file"](frames), reps=3)
        ms_mem = device_ms(lambda q=q: tpch.QUERIES[q](tables), reps=3)
        rows[q] = {"ms_from_file": ms_file, "ms_in_memory": ms_mem}
        log(f"phase 5 IO TPC-H SF10 {q} from Parquet: {ms_file:.1f} ms (read included); "
            f"in memory {ms_mem:.3f} ms [{smi}]")
    # q6's pushdown: row groups and pages read, with and without it
    path = os.path.join(directory, "lineitem.parquet")
    lo, hi = tpch.Q6_RANGE
    kept, total = pn.prune_row_groups(path, [("l_shipdate", ">=", lo), ("l_shipdate", "<", hi)])
    files = iop.tpch_files(frames)
    q6_columns = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
    projected = {"lineitem": scan_parquet(path, q6_columns, device=frames["device"])}
    pages = {}
    # the optimized plan pushes the predicate into the Scan; without the
    # optimizer the projected Scan reads every row group and the Filter runs after
    for label, tables_, flag in (("pushdown", files, False), ("no_pushdown", projected, True)):
        pn.PAGE_COUNTERS.update(decoded=0, skipped=0)
        pages[label] = (tpch.q6(tables_, no_optimization=flag), dict(pn.PAGE_COUNTERS))
    a, b = (float(pages[k][0]._table["revenue"].data[0]) for k in pages)
    check(a == b, f"q6 with and without its pushdown: {a} vs {b}")
    md = pn.read_footer(path)
    rows["q6_pushdown"] = {"row_groups_kept": kept, "row_groups": total,
                           "pages_with": pages["pushdown"][1],
                           "pages_without": pages["no_pushdown"][1],
                           "columns_read": len(q6_columns),
                           "columns_in_file": len(md.schema) - 1}
    log("phase 4 IO TPC-H q6 pushdown: " + json.dumps(dict(rows["q6_pushdown"], card=smi)))
    log("phase 4 IO TPC-H q1 grouping from Parquet: l_returnflag and l_linestatus come "
        "back as STRING (in memory DICTIONARY32); two keys take the sort tier either way")
    # a query from the file = its reads + the query over the frames read
    # (STRING keys where memory holds DICTIONARY32)
    read_columns = {"q1": {"lineitem": ["l_returnflag", "l_linestatus", "l_quantity",
                                        "l_extendedprice", "l_discount", "l_tax",
                                        "l_shipdate"]},
                    "q12": {"lineitem": ["l_orderkey", "l_shipmode", "l_commitdate",
                                         "l_receiptdate", "l_shipdate"],
                            "orders": ["o_orderkey", "o_orderpriority"]}}
    for q, tables_cols in read_columns.items():
        def read_all(tables_cols=tables_cols):
            return {n: ct.read_parquet(os.path.join(directory, f"{n}.parquet"), columns=c,
                                       device=frames["device"]) for n, c in tables_cols.items()}
        read = read_all()
        rows[q]["read_ms"] = wall_ms(read_all, reps=3)
        rows[q]["query_over_read_ms"] = device_ms(lambda q=q: tpch.QUERIES[q](read), reps=3)
        del read
        log(f"phase 5 IO TPC-H SF10 {q} from Parquet split: " + json.dumps(
            dict(rows[q], card=smi)))
    for q in ("q1", "q12"):
        rows[f"{q}_profile"] = profile_split(lambda q=q: iop.REQUESTS[f"tpch_{q}_file"](frames))
        log(f"phase 4 IO TPC-H {q} from Parquet torch.profiler split: " + json.dumps(
            {f"tpch_sf10_{q}_file_profile": rows[f"{q}_profile"], "card": smi}))
    del frames, files, pages
    for name in ("lineitem", "orders", "part"):
        os.remove(os.path.join(directory, f"{name}.parquet"))
    torch.cuda.empty_cache()
    return rows


def io_taxi_phase(dev, smi, wrappers, drive, plains, acc, directory):
    """One taxi month written and read back (the reference's Parquet decode
    bench at a month's size)."""
    from cudf_tpu_torch.io import parquet_native as pn
    from cudf_tpu_torch.models import io_paths as iop

    frames = {"dir": directory, "device": dev, "taxi": iop.taxi_frame(iop.TAXI_ROWS, device=dev)}
    torch.cuda.synchronize()
    res = io_phase("taxi", frames, smi, wrappers, drive, plains, acc)
    path = os.path.join(directory, "taxi.parquet")
    mb = os.path.getsize(path) / 1e6
    ms = wall_ms(lambda: iop.REQUESTS["taxi_read"](frames))
    # the split of three warm reads, beside the wall time of those reads
    pn.TIMING = {}
    t0 = time.perf_counter()
    for _ in range(3):
        iop.REQUESTS["taxi_read"](frames)
        torch.cuda.synchronize()
    split_wall = (time.perf_counter() - t0) * 1e3 / 3
    split = {k: v * 1e3 / 3 for k, v in pn.TIMING.items()}
    pn.TIMING = None
    split["reading_thread_sum"] = sum(v for k, v in split.items()
                                      if not k.startswith("workers_"))
    split["wall_of_these_reads"] = split_wall
    profile = profile_split(lambda: iop.REQUESTS["taxi_read"](frames))
    log("phase 4 IO taxi month read torch.profiler split: " + json.dumps(
        {"taxi_read_profile": profile, "card": smi}))
    write_s = res["taxi_write"]["first_s"]
    row = {"rows": iop.TAXI_ROWS, "file_mb": mb, "read_ms": ms,
           "mb_per_s": mb / ms * 1e3, "rows_per_s": iop.TAXI_ROWS / ms * 1e3,
           "split_ms": split, "profile": profile, "write_s": write_s,
           "first_read_s": res["taxi_read"]["first_s"]}
    acc[2]["taxi_decode"] = row
    log("phase 5 IO taxi month Parquet: " + json.dumps(dict(row, card=smi)))
    del frames
    torch.cuda.empty_cache()
    return row


def io_g1_phase(dev, smi, wrappers, drive, plains, acc, directory):
    """G1_1e7 made, written as CSV and read back; its questions from the
    file; nested columns through Parquet; the frame through the Arrow C
    stream."""
    from cudf_tpu_torch.models import io_paths as iop

    g1df = iop.g1_frame(iop.G1_ROWS, device=dev)
    t0 = time.perf_counter()
    text = iop.g1_csv(g1df)
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t0
    path = os.path.join(directory, "g1.csv")
    iop.write_bytes(path, text)
    mb = text.numel() / 1e6
    del text
    log(f"phase 4 IO G1_1e7_1e2_0_0 CSV: {mb:.1f} MB of text built on the card in "
        f"{text_s:.3f} s")
    frames = {"dir": directory, "device": dev, "g1": g1df}
    frames["nested_list"], frames["nested_struct"] = iop.nested_frame(g1df)
    io_phase("g1", frames, smi, wrappers, drive, plains, acc)
    run = (lambda: iop.REQUESTS["g1_read_csv"](frames))
    ms = wall_ms(run)
    row = {"file_mb": mb, "read_csv_ms": ms, "mb_per_s": mb / ms * 1e3,
           "host_syncs": count_syncs(run),
           "category_by": "read_csv dtype (the reference's device tier ignores it)",
           "v3_max_ulps": acc[2]["g1_read_csv"]["max_abs_err"]}
    for n in ("g1_q1_csv", "g1_q2_csv", "g1_q3_csv", "g1_q4_csv", "g1_q5_csv",
              "nested_list", "nested_struct", "arrow_stream"):
        row[f"{n}_ms"] = wall_ms(lambda n=n: iop.REQUESTS[n](frames), reps=3)
    acc[2]["g1_csv"] = row
    log("phase 5 IO G1 CSV, nested and Arrow: " + json.dumps(dict(row, card=smi)))
    del frames, g1df
    torch.cuda.empty_cache()
    return row


def io_formats_phase(dev, smi, wrappers, drive, plains, acc, directory):
    """JSON, ORC, Avro, the tpudf file, text and the stream consumer
    (``models/io_formats.py``) over G1_1e7 and the taxi month; each
    group's requests through ``io_phase``, then the rates."""
    import importlib.util

    from cudf_tpu_torch.io.json import read_json
    from cudf_tpu_torch.models import g1
    from cudf_tpu_torch.models import io_formats as iof
    from cudf_tpu_torch.models import io_paths as iop

    t0 = time.perf_counter()
    frames = iof.prepare(iop.g1_frame(iop.G1_ROWS, device=dev),
                         iop.taxi_frame(iop.TAXI_ROWS, device=dev), directory, dev)
    torch.cuda.synchronize()
    text_mb = frames["g1_ndjson"].numel() / 1e6
    log(f"phase 4 IO formats: G1_1e7 as NDJSON ({text_mb:.1f} MB, built on the card) and "
        f"two Avro containers (encoded on the host) in {time.perf_counter() - t0:.2f} s")
    rows, seconds = {}, {}

    def path(name):
        return os.path.join(directory, name)

    def rate(name, run, mb, n_rows, reps=3):
        ms = wall_ms(run, reps=reps)
        rows[name] = {"ms": ms, "file_mb": mb, "mb_per_s": mb / ms * 1e3,
                      "rows_per_s": n_rows / ms * 1e3}
        log(f"phase 5 IO {name}: {ms:.1f} ms, {mb / ms * 1e3:.1f} MB/s, "
            f"{n_rows / ms * 1e3:.4g} rows/s [{smi}]")

    for group in iof.GROUPS:
        t0 = time.perf_counter()
        res = io_phase(group, frames, smi, wrappers, drive, plains, acc, models=iof)
        for n, r in res.items():
            if n.endswith("_write"):
                rows[n] = {"first_s": r["first_s"]}
        if group == "json":
            run = (lambda: iof.REQUESTS["g1_json_read"](frames))
            rate("g1_json_read", run, text_mb, iop.G1_ROWS)
            rows["g1_json_read"]["host_syncs"] = count_syncs(run)
            frames.pop("g1_json", None)
            frames.pop("g1_json_categories", None)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run()
            torch.cuda.synchronize()
            rows["g1_json_read"]["peak_device_bytes"] = torch.cuda.max_memory_allocated()
            rows["g1_json_read"]["peak_over_resident_bytes"] = \
                torch.cuda.max_memory_allocated() - base
            rows["g1_json_write"]["mb_per_s"] = text_mb / rows["g1_json_write"]["first_s"]
            mb = os.path.getsize(path("g1_records.json")) / 1e6
            rate("g1_json_records", lambda: read_json(path("g1_records.json"), device=dev), mb,
                 iof.RECORDS_ROWS)
        elif group == "orc":
            for name, frame in (("taxi_orc_read_snappy", "taxi_snappy"),
                                ("taxi_orc_read_zlib", "taxi_zlib"),
                                ("g1_orc_read", "g1_snappy")):
                rate(name, lambda name=name: iof.REQUESTS[name](frames),
                     os.path.getsize(path(f"{frame}.orc")) / 1e6,
                     iop.TAXI_ROWS if frame.startswith("taxi") else iop.G1_ROWS)
        elif group == "avro":
            for codec in ("null", "deflate"):
                name = f"g1_avro_{codec}_read"
                rate(name, lambda name=name: iof.REQUESTS[name](frames),
                     os.path.getsize(path(f"g1_{codec}.avro")) / 1e6, iop.G1_ROWS)
            ms = wall_ms(lambda: iof.REQUESTS["g1_q1_avro"](frames), reps=3)
            rows["g1_q1_avro"] = {"ms": ms, "in_memory_ms": wall_ms(lambda: g1.q1(frames["g1"]),
                                                                    reps=3)}
            log(f"phase 5 IO G1 q1 over the Avro frame: {ms:.3f} ms [{smi}]")
        elif group == "tpudf":
            rate("g1_tpudf_read", lambda: iof.REQUESTS["g1_tpudf_read"](frames),
                 os.path.getsize(path("g1.tpudf")) / 1e6, iop.G1_ROWS)
        elif group == "text":
            rate("g1_text", lambda: iof.REQUESTS["g1_text"](frames), text_mb, iop.G1_ROWS)
        seconds[group] = time.perf_counter() - t0
        log(f"phase 4 IO formats {group}: {seconds[group]:.1f} s")
    for n in ("g1_json", "g1_orc", "g1_avro"):
        frames.pop(n, None)
        frames.pop(f"{n}_categories", None)
    have = importlib.util.find_spec("pyarrow") is not None
    log("phase 4 IO Feather: not run: read_feather and to_feather have one tier, pyarrow's "
        "(the reference's only tier too), and every file request here holds "
        f"IO_ROUTES['pyarrow'] at 0 (pyarrow {'is' if have else 'is not'} importable here)")
    acc[2]["io_formats"] = dict(rows, phase_s=seconds)
    log("phase 5 IO formats: " + json.dumps({"card": smi, "rows": rows, "phase_s": seconds}))
    del frames
    torch.cuda.empty_cache()
    return rows


def partitioned_phase(group, frames, smi, wrappers, drive, plains, acc, replay=(), warm=False):
    """The requests of one group of ``models/partitioned.py`` as one main
    path (every count at 0 before it): each request's wall ms, partition
    count, spill statistics, peak device memory and launches; then each
    result held to the same plan's in-memory ``collect()`` (rows after a
    sort on all columns: exact, floats rtol 1e-9), timed too, and each
    request must have launched its ``NEEDS``.  With ``warm`` both are timed
    again (the median of 3 warm runs, wall clock).  The requests in
    ``replay`` then run alone with every call of their kernels recorded and
    replayed against the plain versions.  Adds rows by request to ``acc``."""
    from cudf_tpu_torch.engine.streaming import LAST_RUN
    from cudf_tpu_torch.models import partitioned as pm
    from cudf_tpu_torch.utils.spill import get_spill_manager

    names = pm.GROUPS[group]
    stats = get_spill_manager().statistics
    results, rows = {}, {}

    def main_path():
        for n in names:
            before = stats.as_dict()
            counts = {k: w.launches for k, w in wrappers.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            results[n] = pm.REQUESTS[n](frames)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = stats.as_dict()
            launched = {k: w.launches - counts[k] for k, w in wrappers.items()
                        if w.launches > counts[k]}
            rows[n] = dict(ms_partitioned=ms, partitions=LAST_RUN["partitions"],
                           file_partitions=LAST_RUN["file_partitions"],
                           spill={k: after[k] - before[k] for k in after},
                           max_memory_allocated=torch.cuda.max_memory_allocated(),
                           launches=launched)
    drive(f"partitioned_{group}", main_path)
    for n in names:
        row = rows[n]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp = pm.IN_MEMORY[n](frames)
        torch.cuda.synchronize()
        row["ms_in_memory"] = (time.perf_counter() - t0) * 1e3
        row["max_abs_err"] = pm.agree(frames, n, results.pop(n), exp)
        del exp
        missing = [k for k in pm.NEEDS[n] if k not in row["launches"]]
        check(not missing, f"partitioned {n} did not launch {missing}: {row['launches']}")
        if n in pm.SPILLS:
            check(row["spill"]["spills"] > 0, f"partitioned {n}: the spill budget never bit")
        if warm:
            row["ms_partitioned_warm"] = wall_ms(lambda n=n: pm.REQUESTS[n](frames), reps=3)
            row["ms_in_memory_warm"] = wall_ms(lambda n=n: pm.IN_MEMORY[n](frames), reps=3)
        torch.cuda.empty_cache()
        acc[2][n] = row
        log(f"phase 4 partitioned {n}: equal to the in-memory executor (max abs err "
            f"{row['max_abs_err']}); " + json.dumps(dict(row, card=smi)))
    for n in replay:
        acc[0][n] = run_replayed(f"partitioned {n}", n, lambda n=n: pm.REQUESTS[n](frames),
                                 wrappers, plains, acc[1], needs=pm.NEEDS[n])
        torch.cuda.empty_cache()
    return rows


def spill_agreement(paths, dev, smi):
    """One ``spill_to_budget`` over the columns of lineitem's files read
    back (fresh device buffers): the bytes the manager reports freed beside
    the drop of ``torch.cuda.memory_allocated``, which must agree within
    5%; then every buffer of every column brought back (data, validity,
    offsets, children) equals, bit for bit, a copy taken before the spill."""
    from cudf_tpu_torch.io.parquet import read_parquet
    from cudf_tpu_torch.utils.spill import SpillManager

    tables = [read_parquet(p, device=dev)._table for p in paths]
    copies = [[[b.clone() for b in c.buffers()] for c in t.columns] for t in tables]
    mgr = SpillManager()
    for t in tables:
        for c in t.columns:
            mgr.register(c)
    live = mgr.device_bytes()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    freed = mgr.spill_to_budget(live // 2)
    torch.cuda.synchronize()
    spill_ms = (time.perf_counter() - t0) * 1e3
    drop = before - torch.cuda.memory_allocated()
    check(freed > 0 and abs(freed - drop) <= 0.05 * drop,
          f"spill_to_budget freed {freed} B, memory_allocated dropped {drop} B")
    t0 = time.perf_counter()
    for t in tables:
        for c in t.columns:
            mgr.ensure_on_device(c)
    torch.cuda.synchronize()
    unspill_ms = (time.perf_counter() - t0) * 1e3
    buffers = 0
    for t, cs in zip(tables, copies):
        for c, refs in zip(t.columns, cs):
            got = list(c.buffers())
            check(len(got) == len(refs), "a column brought back lost a buffer")
            for b, ref in zip(got, refs):
                check(b.device == ref.device and b.dtype == ref.dtype and torch.equal(
                    b.view(torch.uint8), ref.view(torch.uint8)),
                    "a buffer brought back differs from its copy")
                buffers += 1
    row = dict(files=len(paths), buffers_compared=buffers, releasable_bytes=live,
               budget=live // 2, freed=freed,
               memory_allocated_drop=drop, spill_ms=spill_ms, unspill_ms=unspill_ms,
               statistics=mgr.statistics.as_dict())
    log("phase 4 partitioned spill_to_budget: freed beside the drop of memory_allocated: " +
        json.dumps(dict(row, card=smi)))
    del tables, copies
    torch.cuda.empty_cache()
    return row


def partitioned_tpch_phase(tables, smi, wrappers, drive, plains, acc, directory):
    """TPC-H SF10 as a Parquet dataset (lineitem and orders 16 files each)
    and the nine queries through ``collect(streaming=True)``, spilling off
    then on; the spill agreement over lineitem's files."""
    from cudf_tpu_torch.models import partitioned as pm

    sub = os.path.join(directory, "partitioned")
    os.makedirs(sub, exist_ok=True)
    t0 = time.perf_counter()
    paths = pm.write_tpch_dataset(tables, sub)
    write_s = time.perf_counter() - t0
    size = sum(os.path.getsize(p) for ps in paths.values() for p in ps)
    log(f"phase 4 partitioned TPC-H SF10 dataset: {sum(map(len, paths.values()))} Parquet "
        f"files, {size / 1e6:.1f} MB written in {write_s:.2f} s [{smi}]")
    frames = {"tpch": tables, "dataset": pm.tpch_dataset(paths, tables["lineitem"]._table.device),
              "dir": sub}
    partitioned_phase("tpch", frames, smi, wrappers, drive, plains, acc, replay=("tpch_q5",))
    partitioned_phase("tpch_spill", frames, smi, wrappers, drive, plains, acc)
    acc[2]["spill_agreement"] = spill_agreement(paths["lineitem"],
                                                tables["lineitem"]._table.device, smi)
    acc[2]["tpch_dataset"] = {"files": {n: len(p) for n, p in paths.items()},
                              "mb": size / 1e6, "write_s": write_s}
    del frames
    shutil.rmtree(sub, ignore_errors=True)
    torch.cuda.empty_cache()


def distributed_phase(group, frames, smi, wrappers, drive, mesh, acc, replay=()):
    """The requests of one group of ``models/distributed.py`` over ``mesh``
    as one main path (every count at 0 before it): each request's wall ms,
    collectives (calls, bytes and ms by kind), fallbacks, peak device memory
    and launches; then each answer held to the in-memory one (timed too),
    the fallbacks at 0 and the ``NEEDS`` launched; the plans also timed at
    ``collect(mesh=8)``.  The requests in ``replay`` then run alone with
    every call of their kernels replayed against the plain versions.  Adds
    rows by request to ``acc``."""
    from cudf_tpu_torch.engine import get_fallback_stats, reset_fallback_stats
    from cudf_tpu_torch.models import distributed as dm
    from cudf_tpu_torch.parallel.mesh import collective_stats, reset_collective_stats

    names = dm.GROUPS[group]
    results, rows = {}, {}

    def main_path():
        for n in names:
            counts = {k: w.launches for k, w in wrappers.items()}
            reset_fallback_stats()
            reset_collective_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            results[n] = dm.REQUESTS[n](frames, mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rows[n] = dict(ms_mesh=ms, ranks=mesh.size, collectives=collective_stats(),
                           fallbacks=get_fallback_stats(),
                           max_memory_allocated=torch.cuda.max_memory_allocated(),
                           launches={k: w.launches - counts[k] for k, w in wrappers.items()
                                     if w.launches > counts[k]})
    drive(f"distributed_{group}", main_path)
    for n in names:
        row = rows[n]
        check(row["fallbacks"]["count"] == 0,
              f"distributed {n}: {row['fallbacks']} Unlowerable fallbacks")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp = dm.IN_MEMORY[n](frames)
        torch.cuda.synchronize()
        row["ms_in_memory"] = (time.perf_counter() - t0) * 1e3
        row["max_abs_err"] = dm.agree(frames, n, results.pop(n), exp)
        del exp
        missing = [k for k in dm.NEEDS[n] if k not in row["launches"]]
        check(not missing, f"distributed {n} did not launch {missing}: {row['launches']}")
        if n in dm.ENGINE:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dm.REQUESTS[n](frames, 8)
            torch.cuda.synchronize()
            row["ms_partitioned_8"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.empty_cache()
        acc[2][n] = row
        log(f"phase 4 distributed {n}: equal to the in-memory answer (max abs err "
            f"{row['max_abs_err']}), no fallback; " + json.dumps(dict(row, card=smi)))
    for n in replay:
        acc[0][n] = run_replayed(f"distributed {n}", n,
                                 lambda n=n: dm.REQUESTS[n](frames, mesh),
                                 wrappers, acc[3], acc[1], needs=dm.NEEDS[n])
        torch.cuda.empty_cache()
    return rows


def start_mesh(dev, directory):
    """NCCL at world size 1 on ``dev`` over a FileStore in ``directory``,
    and the mesh of that one rank."""
    from cudf_tpu_torch.parallel import bootstrap, make_mesh

    store = torch.distributed.FileStore(os.path.join(directory, "store"), 1)
    bootstrap.initialize(0, 1, store=store, device=dev, local_rank=dev.index or 0)
    mesh = make_mesh(device=dev)
    info = bootstrap.process_info()
    listed = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, check=True,
                            timeout=60).stdout.strip().splitlines()
    log("phase 1 cards: " + json.dumps({"nvidia_smi_L": len(listed),
                                        "torch_device_count": torch.cuda.device_count(),
                                        "used": 1, "process_group": info,
                                        "mesh": repr(mesh)}))
    return mesh


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--beside", metavar="DIR",
                        help="only time kernels A and D beside those of the checkout in DIR "
                             "(e.g. the parent commit), in one process on the same data")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    check(cards == 1, f"{cards} cards visible; the smoke drives one "
                      "(set CUDA_VISIBLE_DEVICES to a single card)")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 1 device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"card: {smi}")

    import cudf_tpu_torch as ct
    from cudf_tpu_torch.kernels import _build
    from cudf_tpu_torch.kernels import hash_aggregate as ha
    from cudf_tpu_torch.kernels import radix_partition as rp
    from cudf_tpu_torch.kernels import tile_sort as ts
    from cudf_tpu_torch.models import j1_join

    t0 = time.perf_counter()
    reported = {"merge_scatter": "merge_scatter.cu", "bucket_aggregate": "radix_partition.cu",
                "onehot_groupby_aggregate": "hash_aggregate.cu"}
    sources = sorted(set(reported.values()))
    fns = {"bucket_aggregate": "bucket_aggregate_kernel",
           "onehot_groupby_aggregate": "onehot_aggregate_kernel",
           "digit_histogram": "digit_histogram_kernel", "radix_scatter": "radix_scatter_kernel"}
    reported.update(digit_histogram="radix_partition.cu", radix_scatter="radix_partition.cu")
    with concurrent.futures.ThreadPoolExecutor(2 * len(sources)) as pool:
        # ptxas -v of G, D, A, B and C, and the shared atomics in SASS of D, A, B and C,
        # beside the build: one compile of each source for each report
        reports = {src: pool.submit(_build.ptxas_report, _build.CSRC / src) for src in sources}
        opcodes = {src: pool.submit(_build.sass_opcodes, _build.CSRC / src, "ATOMS")
                   for src in ("radix_partition.cu", "hash_aggregate.cu")}
        lib = _build.library()
        ptxas = {k: ptxas_lines(reports[src].result(), fns.get(k))
                 for k, src in reported.items()}
        sass = {k: {fn: ops for fn, ops in opcodes[reported[k]].result().items() if fn_name in fn}
                for k, fn_name in fns.items()}
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s ({lib.path.name})")
    for k, lines in ptxas.items():
        for line in lines:
            log(f"  {k} {line}")
    for k, fns in sass.items():
        for fn, ops in fns.items():
            log(f"  {k} SASS shared atomics of {fn}: {ops}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    if args.beside:
        log(json.dumps({"beside": args.beside, "card": smi,
                        "ms": beside_phase(dev, gen, rp, ha, args.beside)}))
        return 0
    mesh_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    mesh = start_mesh(dev, mesh_dir)
    kernels = kernel_phase(dev, gen, ha, rp, ts)
    for k, lines in ptxas.items():
        kernels[k]["ptxas"] = lines
    for k, fns in sass.items():
        kernels[k]["sass_shared_atomics"] = fns
    torch.cuda.empty_cache()
    log("phase 3 G1 kernels: all six agree with their plain versions")

    wrappers = {"onehot_groupby_aggregate": ha.onehot_groupby_aggregate,
                "digit_histogram": rp.digit_histogram,
                "radix_scatter": rp.radix_scatter,
                "tile_sort": ts.tile_sort,
                "tile_sort_data": ts.tile_sort_data,
                "merge_scatter": rp.merge_scatter,
                "bucket_aggregate": rp.bucket_aggregate,
                "window_probe": rp.window_probe}
    paths = {"g1": ["onehot_groupby_aggregate", "digit_histogram", "tile_sort_data",
                    "merge_scatter", "bucket_aggregate"],
             "j1": ["digit_histogram", "tile_sort_data", "merge_scatter", "bucket_aggregate",
                    "window_probe"],
             "j1_sort_merge": [],
             "j1_dict": ["digit_histogram", "tile_sort_data", "merge_scatter",
                         "bucket_aggregate", "window_probe"],
             "tpch": TPCH_PATH, "tpch_frame": TPCH_PATH,
             "g1_questions": ONEHOT_TIER + RADIX_TIER,
             "frame_api_g1": ONEHOT_TIER + RADIX_TIER,
             "frame_api_j1": RADIX_TIER + ["window_probe"], "frame_api_nulls": [],
             "strings_g1": ONEHOT_TIER + RADIX_TIER, "strings_g1_dict": [],
             "strings_lineitem": ONEHOT_TIER, "nested_g1": [], "nested_lineitem": [],
             "ops_windows_g1": [], "ops_windows_j1": [], "ops_windows_lineitem": ONEHOT_TIER,
             "io_tpch": RADIX_TIER + ["window_probe"], "io_taxi": [],
             "io_g1": ONEHOT_TIER + RADIX_TIER, "io_json": ONEHOT_TIER + RADIX_TIER,
             "io_orc": RADIX_TIER, "io_avro": ONEHOT_TIER, "io_tpudf": [], "io_text": [],
             "io_stream": [], "partitioned_g1": ONEHOT_TIER + RADIX_TIER,
             "partitioned_j1": RADIX_TIER + ["window_probe"], "partitioned_tpch": RADIX_TIER + ["window_probe"],
             "partitioned_tpch_spill": RADIX_TIER + ["window_probe"],
             "distributed_g1": ONEHOT_TIER + RADIX_TIER,
             "distributed_j1": RADIX_TIER + ["window_probe"],
             "distributed_tpch": RADIX_TIER + ["window_probe"]}
    launches = {name: {} for name in wrappers}
    second_pass = {}

    def drive(path, run):
        """Run one main path with every count at 0 before, read after."""
        for fn in wrappers.values():
            fn.launches = 0
        rp.radix_partition.second_passes = 0
        out = run()
        torch.cuda.synchronize()
        for name, fn in wrappers.items():
            launches[name][path] = fn.launches
        second_pass[path] = rp.radix_partition.second_passes
        for name in paths[path]:
            check(launches[name][path] > 0, f"kernel {name} was not launched by the {path} path")
        return out

    df = g1_frame(ct, dev, gen)
    results = drive("g1", lambda: {name: df.groupby(key).agg(spec)
                                   for name, (key, spec) in QUERIES.items()})
    for name, (key, spec) in QUERIES.items():
        check_query(name, results[name], plain_query(df, key, spec))
    del results
    log(f"phase 4 G1 main path: q4, q5, bench K=100 and K=1e6 agree with plain torch; "
        f"launches { {k: v['g1'] for k, v in launches.items()} }")
    by_query = {}
    for name, (key, spec) in QUERIES.items():   # each query alone, every count at 0 before
        for fn in wrappers.values():
            fn.launches = 0
        df.groupby(key).agg(spec)
        torch.cuda.synchronize()
        by_query[name] = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    log(f"phase 4 G1 launches by query: {by_query}")
    check(by_query["q4"].get("onehot_groupby_aggregate") == 1, "q4: one kernel A launch")
    check(by_query["q5"].get("bucket_aggregate") == 1, "q5: one kernel D launch")
    wide = wide_frame(ct, df)
    spec = {name: "sum" for name in wide._table.names if name != "id6"}
    check_query("q5 six values", wide.groupby("id6").agg(spec),
                plain_query(wide, "id6", spec))
    del wide
    torch.cuda.empty_cache()
    log("phase 4 G1 six value columns by id6 (more payloads than one partition "
        "launch carries) agree with plain torch")
    sort_queries = {"q6": (q6, plain_q6, check_q6), "q8": (q8, plain_q8, check_q8)}
    for name, (fn, plain, chk) in sort_queries.items():   # alone, every count at 0 before
        for w in wrappers.values():
            w.launches = 0
        res = fn(df)
        torch.cuda.synchronize()
        by_query[name] = {k: w.launches for k, w in wrappers.items() if w.launches}
        got = chk(name, res, plain(df))
        del res
        torch.cuda.empty_cache()
        log(f"phase 4 G1 {name} (the sort tier) agrees with plain torch "
            f"({'max abs err ' + str(got) if name == 'q6' else str(got) + ' rows'}); "
            f"launches of A-H {by_query[name]}")
    check(not by_query["q6"] and not by_query["q8"], "q6 or q8 launched a kernel of A-H")
    nulls = g1_null_frame(ct, dev, torch.Generator(device=dev).manual_seed(SEED + 6), N // 10)
    err = check_q6("q6 with 5% nulls", q6(nulls), plain_q6(nulls))
    log(f"phase 4 G1 q6 at 1e7 rows with 5% nulls in id4, id5, v3 (G1_1e7_1e2_5_0's shape, "
        f"dropna=False: a null group for each key) agrees with plain torch, max abs err {err}")
    del nulls
    torch.cuda.empty_cache()
    log("phase 4 G1 q6 torch.profiler split: " + json.dumps(
        {"q6_profile": profile_split(lambda: q6(df)), "card": smi}))

    for name, (key, spec) in QUERIES.items():
        ms = device_ms(lambda: df.groupby(key).agg(spec))
        plain = device_ms(lambda: plain_query(df, key, spec))
        log(f"phase 5 G1 {name}: {ms:.3f} ms = {N / ms * 1e3:.4g} rows/s; plain torch "
            f"{plain:.3f} ms = {N / plain * 1e3:.4g} rows/s [{smi}]")
    for name, (fn, plain_fn, _) in sort_queries.items():
        ms = device_ms(lambda: fn(df))
        plain = device_ms(lambda: plain_fn(df))
        log(f"phase 5 G1 {name} (sort tier): {ms:.3f} ms = {N / ms * 1e3:.4g} rows/s; plain "
            f"torch {plain:.3f} ms = {N / plain * 1e3:.4g} rows/s [{smi}]")
        torch.cuda.empty_cache()
    plains = {"onehot_groupby_aggregate": ha.onehot_groupby_aggregate_plain,
              "digit_histogram": rp.digit_histogram_plain,
              "tile_sort_data": ts.tile_sort_data_plain,
              "merge_scatter": rp.merge_scatter_plain,
              "bucket_aggregate": rp.bucket_aggregate_plain,
              "window_probe": rp.window_probe_plain}
    by_question, g1_calls, question_times = g1_question_phase(df, smi, wrappers, drive, plains)
    by_api, api_calls, api_times = g1_api_phase(df, smi, wrappers, plains)
    for name, rows in api_calls.items():
        g1_calls.setdefault(name, []).extend(rows)
    log("phase 5 G1 questions and API times: " + json.dumps(
        {"card": smi, "questions": question_times, "api": api_times}))
    frame_api = ({}, {}, {})            # launches by request, replayed calls, times
    add_frame_api(frame_api, frame_api_phase("g1", {"g1": df}, smi, wrappers, drive, plains))
    strings = ({}, {}, {})              # launches by request, replayed calls, times
    g1_text = {"g1": df}
    for group in ("g1", "g1_dict"):
        strings_dt_phase(group, g1_text, smi, wrappers, drive, plains, strings)
    nested = ({}, {}, {})               # launches by request, replayed calls, times
    nested_g1_checks(df, nested_phase("g1", g1_text, smi, wrappers, drive, plains, nested))
    ops = ({}, {}, {})                  # launches by request, replayed calls, times
    ops_windows_phase("g1", g1_text, smi, wrappers, drive, plains, ops)
    ops_windows_g1_checks(g1_text, smi)
    part = ({}, {}, {})                 # launches by request, replayed calls, rows
    partitioned_phase("g1", {"g1": df}, smi, wrappers, drive, plains, part,
                      replay=("g1_k100", "g1_k1e6"), warm=True)
    spmd = ({}, {}, {}, plains)         # launches by request, replayed calls, rows, plains
    distributed_phase("g1", {"g1": df}, smi, wrappers, drive, mesh, spmd)
    del df, g1_text
    torch.cuda.empty_cache()

    j1_rows, j1_modes, route_ms = j1_kernel_phase(dev, gen, rp, ts)
    kernels.update(j1_rows)
    kernels["merge_scatter"]["route_ms_j1_big"] = route_ms
    for name, modes in j1_modes.items():
        if modes:
            kernels[name].setdefault("modes", {}).update(modes)
    torch.cuda.empty_cache()
    log("phase 3 J1 kernels: D's id/idpay modes, B, C, E, F, G and H (five shapes) agree "
        "exactly with their plain versions")

    frames = j1_frames(ct, dev, gen)
    results = drive("j1", lambda: {
        name: frames[left].merge(frames[right], on="id")
        for name, (left, right, _) in J1_QUERIES.items()})
    for name, (left, right, unique) in J1_QUERIES.items():
        rows = check_merge(name, results.pop(name),
                           plain_merge(frames[left], frames[right], unique))
        log(f"phase 4 J1 {name}: {rows} rows, equal to the plain torch join")
    torch.cuda.empty_cache()
    check(second_pass["j1"] > 0, "the J1 path ran no second pass of the sorted route")
    log(f"phase 4 J1 main path: launches { {k: v['j1'] for k, v in launches.items()} }; "
        f"second passes of the sorted route: {second_pass['j1']}")
    rows_i = torch.arange(N, dtype=torch.int32, device=dev)
    for size in J1_DIMS:
        check_j1_model(j1_join, rows_i, *j1_model_inputs(frames, size), size)
    log("phase 4 J1 models.j1_join: small, medium and big agree with plain torch")

    for name, (left, right, unique) in J1_QUERIES.items():
        lf, rf = frames[left], frames[right]
        probe = max(len(lf), len(rf))
        ms = device_ms(lambda: lf.merge(rf, on="id"))
        plain = device_ms(lambda: plain_merge(lf, rf, unique))
        log(f"phase 5 J1 merge {name}: {ms:.3f} ms = {probe / ms * 1e3:.4g} probe rows/s; "
            f"plain torch {plain:.3f} ms = {probe / plain * 1e3:.4g} probe rows/s [{smi}]")
        torch.cuda.empty_cache()
    for size in J1_DIMS:
        lcodes, rcodes, n_dim = j1_model_inputs(frames, size)
        ms = device_ms(lambda: j1_join(lcodes, rows_i, rcodes, n_dim))
        plain = device_ms(lambda: plain_probe(lcodes, rcodes, n_dim))
        log(f"phase 5 J1 j1_join {size}: {ms:.3f} ms = {N / ms * 1e3:.4g} probe rows/s; "
            f"plain torch {plain:.3f} ms = {N / plain * 1e3:.4g} probe rows/s [{smi}]")

    del rows_i, lf, rf, lcodes, rcodes
    torch.cuda.empty_cache()
    j1_sort_merge_phase(ct, frames, drive, smi)
    check(not any(launches[n]["j1_sort_merge"] for n in wrappers),
          "the J1 sort-merge joins launched a kernel of A-H")
    add_frame_api(frame_api, frame_api_phase("j1", frames, smi, wrappers, drive, plains))
    j1_big = {"fact": frames["fact_big"][["id"]], "dim": frames["dim_big"][["id"]]}
    ops_windows_phase("j1", j1_big, smi, wrappers, drive, plains, ops)
    ops[2]["bloom_j1_big"].update(ops_windows_j1_checks(j1_big, smi))
    del j1_big
    partitioned_phase("j1", {"fact": frames["fact_big"], "dim": frames["dim_big"]}, smi,
                      wrappers, drive, plains, part, replay=("j1_big_shuffle",), warm=True)
    distributed_phase("j1", {"fact": frames["fact_big"], "dim": frames["dim_big"]}, smi,
                      wrappers, drive, mesh, spmd, replay=("j1_big_shuffle",))
    v1 = frames["fact_big"]._table["v1"].data
    del frames
    torch.cuda.empty_cache()
    j1_dict_phase(ct, dev, gen, v1, drive, smi)
    del v1
    torch.cuda.empty_cache()
    io = ({}, {}, {})                   # launches by request, replayed calls, rows
    directory = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        (by_tpch_query, tpch_calls, by_frame_query, frame_calls, frame_times,
         over_rows) = tpch_phase(dev, smi, wrappers, drive, plains, strings, nested, ops,
                                 io, part, directory, (mesh, spmd))
        io_taxi_phase(dev, smi, wrappers, drive, plains, io, directory)
        io_g1_phase(dev, smi, wrappers, drive, plains, io, directory)
        io_formats_phase(dev, smi, wrappers, drive, plains, io, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    from cudf_tpu_torch.io import IO_ROUTES

    check(IO_ROUTES["pyarrow"] == 0 and IO_ROUTES["pandas"] == 0 and IO_ROUTES["native"] > 0,
          f"IO routes {IO_ROUTES}")
    log("phase 5 IO rows: " + json.dumps({"card": smi, "io_routes": IO_ROUTES,
                                          "rows": io[2]}))
    log("phase 5 partitioned executor rows: " + json.dumps({"card": smi, "rows": part[2]}))
    log("phase 5 distributed rows (one rank, NCCL): " + json.dumps(
        {"card": smi, "rows": spmd[2]}))
    for name, calls in tpch_calls.items():
        kernels[name]["tpch_calls"] = calls
    for name, calls in frame_calls.items():
        kernels[name]["tpch_frame_calls"] = calls
    for name, calls in g1_calls.items():
        kernels[name]["g1_calls"] = calls
    log("phase 5 TPC-H frame SF10 times: " + json.dumps({"card": smi, "ms": frame_times,
                                                         "over": over_rows}))
    prim = primitives_phase(ct, dev, torch.Generator(device=dev).manual_seed(SEED + 12), smi)
    log("phase 5 primitives at 1e8 G1 rows with 5% nulls: " + json.dumps(
        {"card": smi, "ms": prim}))
    torch.cuda.empty_cache()
    null_frames = frame_api_null_frames(ct, dev, torch.Generator(device=dev).manual_seed(
        SEED + 14))
    add_frame_api(frame_api, frame_api_phase("nulls", null_frames, smi, wrappers, drive, plains))
    del null_frames
    torch.cuda.empty_cache()
    log("phase 5 frame API times: " + json.dumps({"card": smi, "ms": frame_api[2]}))
    for name, calls in frame_api[1].items():
        kernels[name]["frame_api_calls"] = calls
    log("phase 5 strings and temporals times: " + json.dumps({"card": smi, "ms": strings[2]}))
    from cudf_tpu_torch.ops._utils import HOST_ROUTES
    from cudf_tpu_torch.ops.strings import STRING_ROUTES

    log("phase 5 nested and decimal times: " + json.dumps(
        {"card": smi, "ms": nested[2], "string_routes": STRING_ROUTES,
         "host_routes": HOST_ROUTES}))
    from cudf_tpu_torch.frame.series import UDF_ROUTES

    log("phase 5 ops and windows times: " + json.dumps({"card": smi, "ms": ops[2]}))
    log("phase 5 host routes: " + json.dumps({"host_routes": HOST_ROUTES,
                                              "string_routes": STRING_ROUTES,
                                              "udf_routes": UDF_ROUTES}))
    for name, calls in ops[1].items():
        kernels[name]["ops_windows_calls"] = calls
    for name, calls in strings[1].items():
        kernels[name]["strings_dt_calls"] = calls
    for name, calls in io[1].items():
        kernels[name]["io_calls"] = calls
    for name, calls in part[1].items():
        kernels[name]["partitioned_calls"] = calls
    for name, calls in spmd[1].items():
        kernels[name]["distributed_calls"] = calls

    sources = {"onehot_groupby_aggregate": (ha.SOURCE, ha.REPLACES),
               "window_probe": (rp.PROBE_SOURCE, rp.REPLACES["window_probe"]),
               "merge_scatter": (rp.MERGE_SOURCE, rp.REPLACES["merge_scatter"])}
    for name in ("tile_sort", "tile_sort_data"):
        sources[name] = (ts.SOURCE, ts.REPLACES[name])
    for name in ("digit_histogram", "radix_scatter", "bucket_aggregate"):
        sources[name] = (rp.SOURCE, rp.REPLACES[name])
    log(smi)
    keys = ("source", "replaces", "launches", "launches_by_path", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for name, row in kernels.items():
        row.update(source=sources[name][0], replaces=sources[name][1],
                   launches=sum(launches[name].values()), launches_by_path=launches[name],
                   launches_by_g1_query={q: c.get(name, 0) for q, c in by_query.items()},
                   launches_by_tpch_query={q: c.get(name, 0) for q, c in by_tpch_query.items()},
                   launches_by_tpch_frame_query={q: c.get(name, 0)
                                                 for q, c in by_frame_query.items()},
                   launches_by_g1_question={q: c.get(name, 0) for q, c in by_question.items()},
                   launches_by_g1_api={q: c.get(name, 0) for q, c in by_api.items()},
                   launches_by_frame_api={q: c.get(name, 0) for q, c in frame_api[0].items()},
                   launches_by_strings_dt={q: c.get(name, 0) for q, c in strings[0].items()},
                   launches_by_nested={q: c.get(name, 0) for q, c in nested[0].items()},
                   launches_by_ops_windows={q: c.get(name, 0) for q, c in ops[0].items()},
                   launches_by_io={q: c.get(name, 0) for q, c in io[0].items()},
                   launches_by_partitioned={q: r["launches"].get(name, 0)
                                            for q, r in part[2].items() if "launches" in r},
                   launches_by_distributed={q: r["launches"].get(name, 0)
                                            for q, r in spmd[2].items()})
        rows.append(dict(name=name, route="cuda", **{k: row[k] for k in keys},
                         **{k: v for k, v in row.items() if k not in keys}))
    log(json.dumps({"kernels": rows}))
    from cudf_tpu_torch.parallel import bootstrap

    bootstrap.shutdown()
    shutil.rmtree(mesh_dir, ignore_errors=True)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
