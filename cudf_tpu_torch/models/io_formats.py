"""The other file formats on the card (JSON, ORC, Avro, the tpudf file,
text and the stream consumer), each request beside a plain check
written apart from the port's readers and writers.

Data, made from seeds (``models/io_paths.py``'s frames):

- G1_1e7_1e2_0_0 (``io_paths.g1_frame``) as NDJSON: ``g1_ndjson`` builds
  pandas' ``to_json(orient="records", lines=True)`` text of it on the
  device (~112 bytes a row), each field's bytes a key or digit matrix
  with its lengths, scattered after the row's earlier fields; v3, held
  to 6 decimals, as ujson writes it (its whole part, ".", the decimals
  without trailing zeros, ".0" for none).  The lines form is what log
  and event pipelines emit and ``pandas.read_json(lines=True)`` reads.
- the taxi month (``io_paths.taxi_frame``) and G1_1e7 as ORC, snappy and
  zlib, written by the port (id1-id3 as STRING);
- G1_1e7 as an Avro container (``g1_avro``: id1-id3 string, id4-v2 int,
  v3 double; blocks of 64 Ki rows; the null and deflate codecs), encoded
  on the host with numpy (zigzag varints by their byte counts); test data
  only, as the reference has no Avro writer.

``REQUESTS[name](frames)`` is what a user calls; ``PLAIN[name](frames,
result)`` checks the result and returns its max abs error (0.0: bit for
bit; for v3 read from text, ulps).  ``NEEDS[name]`` are the kernels of
A-H a request launches (the G1 questions over the frames read: q1 and q4
the one-hot tier A, q3 and q5 the radix tier B, F, G, D; q2 the sort
tier, none); the readers and writers launch none.  ``ROUTE[name]`` is
the ``io.IO_ROUTES`` tier: "native" for every request.  ``KEEP[name]``
is the ``frames`` key a request's result is kept under for the requests
after it; ``ONCE`` the requests that are not replayed alone (writes and
the stream, which rewrite files).
"""

from __future__ import annotations

import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cudf_tpu_torch.models import io_paths as iop

RECORDS_ROWS = 1_000_000
AVRO_BLOCK_ROWS = 65_536
STREAM_APPENDS = 10
G1_INTS = ("id4", "id5", "id6", "v1", "v2")
SYNC = bytes(range(16))


# ----------------------------------------------------------------------
# the G1 NDJSON text, on the device
# ----------------------------------------------------------------------

def _const(text: str, n: int, device):
    b = torch.tensor(list(text.encode()), dtype=torch.uint8, device=device)
    return b.unsqueeze(0).expand(n, b.numel()), torch.full((n,), b.numel(), dtype=torch.int64,
                                                          device=device)


def _decimals(micro: torch.Tensor):
    """(".dddddd" without trailing zeros, ".0" for none, lengths)."""
    mat, lens = iop._frac_piece(micro)
    mat = mat.clone()
    mat[:, 1] = torch.where(lens == 0, ord("0"), mat[:, 1])
    return mat, torch.where(lens == 0, 2, lens)


def g1_ndjson(df) -> torch.Tensor:
    """uint8 tensor: the G1 frame as pandas writes it with
    ``to_json(orient="records", lines=True)``, built on the device."""
    t = df._table
    dev, n = t.device, t.num_rows
    micro = torch.round(t["v3"].data * 1e6)
    pieces = []
    for i, name in enumerate(("id1", "id2", "id3")):
        pieces += [_const(("{" if i == 0 else '",') + f'"{name}":"', n, dev),
                   iop._dict_piece(t[name])]
    for i, name in enumerate(G1_INTS):
        pieces += [_const(('",' if i == 0 else ",") + f'"{name}":', n, dev),
                   iop._int_piece(t[name].data)]
    pieces += [_const(',"v3":', n, dev), iop._int_piece(micro // 1_000_000), _decimals(micro),
               _const("}\n", n, dev)]
    row_len = sum(lens for _, lens in pieces)
    out = torch.empty(int(row_len.sum()), dtype=torch.uint8, device=dev)
    at = torch.cumsum(row_len, 0) - row_len
    for mat, lens in pieces:
        for p in range(mat.shape[1]):
            keep = p < lens
            out[(at + p)[keep]] = mat[:, p][keep]
        at += lens
    return out


# ----------------------------------------------------------------------
# the G1 Avro container, on the host
# ----------------------------------------------------------------------

G1_AVRO_SCHEMA = {"type": "record", "name": "G1", "fields": (
    [{"name": n, "type": "string"} for n in ("id1", "id2", "id3")]
    + [{"name": n, "type": "int"} for n in G1_INTS] + [{"name": "v3", "type": "double"}])}


def zigzag_varints(v: np.ndarray):
    """(uint8 [n, w], byte counts) of Avro's zigzag varints of int64 values
    (w the most bytes one takes)."""
    u = (v.astype(np.int64) << 1) ^ (v.astype(np.int64) >> 63)
    u = u.view(np.uint64)
    nbytes = np.ones(u.shape, np.int64)
    top = int(u.max()) if u.size else 0
    for k in range(1, 10):
        if top < 1 << (7 * k):
            break
        nbytes += u >= (np.uint64(1) << np.uint64(7 * k))
    k = np.arange(int(nbytes.max()) if nbytes.size else 1, dtype=np.uint64)
    mat = ((u[:, None] >> (np.uint64(7) * k)) & np.uint64(0x7F)).astype(np.uint8)
    mat |= np.where(k[None, :] < (nbytes[:, None] - 1).astype(np.uint64), 0x80, 0).astype(np.uint8)
    return mat, nbytes


def avro_rows(df):
    """(uint8 bytes of every record, the records' byte offsets)."""
    t = df._table
    n = t.num_rows
    pieces = []
    for name in ("id1", "id2", "id3"):
        mat, lens = iop._dict_piece(t[name])
        mat, lens = mat.cpu().numpy(), lens.cpu().numpy()
        pieces += [zigzag_varints(lens), (mat, lens)]
    for name in G1_INTS:
        pieces.append(zigzag_varints(t[name].data.cpu().numpy()))
    v3 = t["v3"].data.cpu().numpy().astype("<f8")
    pieces.append((v3.view(np.uint8).reshape(n, 8), np.full(n, 8, np.int64)))
    row_len = sum(lens for _, lens in pieces)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(row_len, out=offsets[1:])
    total = int(offsets[-1])
    out = np.empty(total + 1, np.uint8)          # the last: where bytes past a length go
    at = offsets[:-1].copy()
    for mat, lens in pieces:
        for p in range(mat.shape[1]):
            out[np.where(p < lens, at + p, total)] = mat[:, p]
        at += lens
    return out[:total], offsets


def _zz(v: int) -> bytes:
    mat, nb = zigzag_varints(np.asarray([v], np.int64))
    return mat[0, :nb[0]].tobytes()


def g1_avro(df, codec: str = "null", block_rows: int = AVRO_BLOCK_ROWS, rows=None) -> bytes:
    """The G1 frame as an Avro object container file (``rows``: its
    ``avro_rows``, when already made)."""
    body, offsets = rows or avro_rows(df)
    n = offsets.shape[0] - 1
    meta = {"avro.schema": json.dumps(G1_AVRO_SCHEMA).encode(), "avro.codec": codec.encode()}
    head = bytearray(b"Obj\x01") + _zz(len(meta))
    for k, v in meta.items():
        head += _zz(len(k)) + k.encode() + _zz(len(v)) + v
    head += _zz(0) + SYNC

    def block(lo):
        hi = min(n, lo + block_rows)
        raw = body[offsets[lo]:offsets[hi]].tobytes()
        if codec == "deflate":
            raw = zlib.compress(raw)[2:-4]
        elif codec != "null":
            raise ValueError(f"codec {codec!r}")
        return _zz(hi - lo) + _zz(len(raw)) + raw + SYNC

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        blocks = list(pool.map(block, range(0, n, block_rows)))
    return bytes(head) + b"".join(blocks)


# ----------------------------------------------------------------------
# requests
# ----------------------------------------------------------------------

def _path(frames, name):
    return os.path.join(frames["dir"], name)


def _dev(frames):
    return frames["device"]


def _json_write(frames):
    frames["g1"].to_json(_path(frames, "g1.ndjson"), lines=True)
    return os.path.getsize(_path(frames, "g1.ndjson"))


def _json_read(frames):
    """G1 as the pandas solution reads it: id1-id3 categories, the ints
    int32 (``io_paths.G1_CSV_DTYPES``)."""
    from cudf_tpu_torch.io.json import read_json

    return read_json(_path(frames, "g1.ndjson"), lines=True, dtype=iop.G1_CSV_DTYPES,
                     device=_dev(frames))


def _records_frame(frames):
    return frames["g1"].iloc[:RECORDS_ROWS]


def _json_records(frames):
    from cudf_tpu_torch.io.json import read_json

    path = _path(frames, "g1_records.json")
    if not os.path.exists(path):
        _records_frame(frames).to_json(path)
    return read_json(path, device=_dev(frames))


def _orc_write(frame, comp):
    def run(frames):
        path = _path(frames, f"{frame}_{comp}.orc")
        frames[frame].to_orc(path, compression=comp)
        return os.path.getsize(path)
    return run


def _orc_read(frame, comp):
    def run(frames):
        from cudf_tpu_torch.io.orc import read_orc

        return read_orc(_path(frames, f"{frame}_{comp}.orc"), device=_dev(frames))
    return run


def _avro_read(codec):
    def run(frames):
        from cudf_tpu_torch.io.avro import read_avro

        return read_avro(_path(frames, f"g1_{codec}.avro"), device=_dev(frames))
    return run


def _tpudf_write(frames):
    frames["g1"].to_tpudf(_path(frames, "g1.tpudf"))
    return os.path.getsize(_path(frames, "g1.tpudf"))


def _tpudf_read(frames):
    from cudf_tpu_torch.io.tpudf_file import read_tpudf

    return read_tpudf(_path(frames, "g1.tpudf"), device=_dev(frames))


def _text(frames):
    from cudf_tpu_torch.io.text import read_text

    return read_text(_path(frames, "g1.ndjson"), device=_dev(frames))


def _stream(frames):
    """The NDJSON appended to a growing file in ``STREAM_APPENDS`` pieces,
    each but the last cut mid-record, a poll after each: (each poll's
    frame, its byte range, the file's end after the append)."""
    from cudf_tpu_torch.io.streaming import FileLogSource, StreamConsumer

    text = frames["g1_ndjson_host"]
    path = _path(frames, "g1_stream.ndjson")
    open(path, "wb").close()
    consumer = StreamConsumer(FileLogSource(path), device=_dev(frames))
    cuts = [len(text) * k // STREAM_APPENDS for k in range(1, STREAM_APPENDS)]
    cuts = [c + 1 if text[c - 1:c] == b"\n" else c for c in cuts] + [len(text)]  # mid-record
    polls, at = [], 0
    for cut in cuts:
        with open(path, "ab") as f:
            f.write(text[at:cut])
        at = cut
        before = consumer.committed
        polls.append((consumer.poll(), before, consumer.committed, cut))
    os.remove(path)
    return polls


def categories(df):
    """id1-id3 as categories, as the pandas solution holds G1 (an ORC or
    Avro file holds them as strings)."""
    names = [n for n in ("id1", "id2", "id3") if not df._table[n].dtype.is_dictionary]
    if not names:
        return df
    out = df.copy()
    for name in names:
        out[name] = out[name].astype("category")
    return out


def _g1_question(q, frame):
    def run(frames):
        from cudf_tpu_torch.models import g1

        if f"{frame}_categories" not in frames:
            frames[f"{frame}_categories"] = categories(frames[frame])
        return g1.QUESTIONS[q](frames[f"{frame}_categories"])
    return run


REQUESTS = {
    "g1_json_write": _json_write,
    "g1_json_read": _json_read,
    **{f"g1_{q}_json": _g1_question(q, "g1_json") for q in ("q1", "q2", "q3", "q4", "q5")},
    "g1_json_records": _json_records,
    "taxi_orc_write_snappy": _orc_write("taxi", "snappy"),
    "taxi_orc_read_snappy": _orc_read("taxi", "snappy"),
    "taxi_orc_write_zlib": _orc_write("taxi", "zlib"),
    "taxi_orc_read_zlib": _orc_read("taxi", "zlib"),
    "g1_orc_write": _orc_write("g1", "snappy"),
    "g1_orc_read": _orc_read("g1", "snappy"),
    "g1_q3_orc": _g1_question("q3", "g1_orc"),
    "g1_avro_null_read": _avro_read("null"),
    "g1_avro_deflate_read": _avro_read("deflate"),
    "g1_q1_avro": _g1_question("q1", "g1_avro"),
    "g1_tpudf_write": _tpudf_write,
    "g1_tpudf_read": _tpudf_read,
    "g1_text": _text,
    "g1_stream": _stream,
}
GROUPS = {
    "json": ["g1_json_write", "g1_json_read", "g1_q1_json", "g1_q2_json", "g1_q3_json",
             "g1_q4_json", "g1_q5_json", "g1_json_records"],
    "orc": ["taxi_orc_write_snappy", "taxi_orc_read_snappy", "taxi_orc_write_zlib",
            "taxi_orc_read_zlib", "g1_orc_write", "g1_orc_read", "g1_q3_orc"],
    "avro": ["g1_avro_null_read", "g1_avro_deflate_read", "g1_q1_avro"],
    "tpudf": ["g1_tpudf_write", "g1_tpudf_read"],
    "text": ["g1_text"],
    "stream": ["g1_stream"],
}
KEEP = {"g1_json_read": "g1_json", "g1_orc_read": "g1_orc", "g1_avro_null_read": "g1_avro"}
ONCE = {"g1_stream"}


def prepare(g1df, taxi, directory: str, device) -> dict:
    """The frames and the files the requests read that no request writes:
    the device-built NDJSON text (on the device and the host) and the two
    Avro containers."""
    frames = {"dir": directory, "device": device, "g1": g1df, "taxi": taxi}
    frames["g1_ndjson"] = g1_ndjson(g1df)
    frames["g1_ndjson_host"] = frames["g1_ndjson"].cpu().numpy().tobytes()
    rows = avro_rows(g1df)
    for codec in ("null", "deflate"):
        with open(os.path.join(directory, f"g1_{codec}.avro"), "wb") as f:
            f.write(g1_avro(g1df, codec, rows=rows))
    return frames


# ----------------------------------------------------------------------
# plain checks
# ----------------------------------------------------------------------

_need, Mismatch = iop._need, iop.Mismatch


def _plain_json_write(frames, size):
    with open(_path(frames, "g1.ndjson"), "rb") as f:
        got = np.frombuffer(f.read(), np.uint8)
    exp = frames["g1_ndjson"].cpu().numpy()
    _need(got.shape == exp.shape and np.array_equal(got, exp),
          f"G1 to_json: {got.size} bytes, not the device-built text's {exp.size}")
    return 0.0


def g1_equal(got, exp, what: str, ulps: int = 1) -> float:
    """ints exact, id1-id3 by their strings (STRING or DICTIONARY), v3
    within ``ulps``; the largest v3 error in ulps."""
    g, e = got._table, exp._table
    _need(list(g.names) == list(e.names), f"{what}: columns {list(g.names)}")
    for n in ("id1", "id2", "id3"):
        a, b = g[n], e[n]
        a = a.decode_dictionary() if a.dtype.is_dictionary else a
        iop.same_bits(a, b.decode_dictionary(), f"{what} {n}")
    for n in G1_INTS:
        _need(g[n].validity is None and torch.equal(g[n].data.long(), e[n].data.long()),
              f"{what} {n}")
    d = (g["v3"].data.view(torch.int64) - e["v3"].data.view(torch.int64)).abs()
    worst = int(d.max()) if d.numel() else 0
    _need(worst <= ulps and g["v3"].validity is None, f"{what} v3: {worst} ulps")
    return float(worst)


def _plain_g1_read(what, ulps=1):
    def check(frames, res):
        return g1_equal(res, frames["g1"], what, ulps)
    return check


def _plain_records(frames, res):
    return g1_equal(res, _records_frame(frames), "G1 records orient")


def _plain_question(q, frame):
    def check(frames, res):
        from cudf_tpu_torch.models import g1

        exp = g1.QUESTIONS[q](frames["g1"])._table
        got = res._table
        _need(list(got.names) == list(exp.names), f"G1 {q} over {frame}: columns")
        err = 0.0
        for n in exp.names:
            a, b = got[n], exp[n]
            if a.dtype.is_dictionary or a.dtype.is_string or b.dtype.is_dictionary:
                a = a.decode_dictionary() if a.dtype.is_dictionary else a
                b = b.decode_dictionary() if b.dtype.is_dictionary else b
                iop.same_bits(a, b, f"G1 {q} over {frame} {n}")
            elif a.data.is_floating_point():
                _need(torch.allclose(a.data, b.data, rtol=1e-12, atol=0.0),
                      f"G1 {q} over {frame} {n}: differs")
                err = max(err, float((a.data - b.data).abs().max()) if a.length else 0.0)
            else:
                _need(torch.equal(a.data.long(), b.data.long()), f"G1 {q} over {frame} {n}")
        return err
    return check


def _plain_size(frames, size):
    return 0.0 if size > 0 else float("inf")


def _plain_same(frame):
    def check(frames, res):
        return iop.same_frame(res, frames[frame], f"{frame} read back")
    return check


def _plain_orc_g1(frames, res):
    """id1-id3 come back as STRING (ORC has no dictionary type in a
    column's type), the rest bit for bit."""
    return g1_equal(res, frames["g1"], "G1 from ORC", ulps=0)


def _plain_text(frames, res):
    """As many records as lines, each the line without its newline: the
    lengths, and the first and last rows, against the device text."""
    text = frames["g1_ndjson"]
    ends = torch.nonzero(text == 10).flatten()
    starts = torch.cat([ends.new_zeros(1), ends[:-1] + 1])
    col = res._column
    _need(col.length == ends.numel(), f"read_text: {col.length} records, {ends.numel()} lines")
    _need(torch.equal(col.offsets[1:] - col.offsets[:-1], ends - starts), "read_text: lengths")
    for i in (0, col.length - 1):
        a = col.data[col.offsets[i]:col.offsets[i + 1]]
        _need(torch.equal(a, text[starts[i]:ends[i]]), f"read_text: row {i}")
    return 0.0


def _plain_stream(frames, polls):
    """Every append but the last ends mid-record; each poll returns the
    records the appends completed, up to the last newline, and the polls
    together are the frame."""
    from cudf_tpu_torch.frame.reshape import concat

    host = frames["g1_ndjson_host"]
    for df, lo, hi, cut in polls:
        expect = host.count(b"\n", lo, hi)
        _need(cut == len(host) or host[cut - 1:cut] != b"\n",
              f"stream: an append ends a record at {cut}")
        _need(hi == 0 or host[hi - 1:hi] == b"\n", f"stream: poll ends mid-record at {hi}")
        _need(hi == lo + host[lo:cut].rfind(b"\n") + 1 if b"\n" in host[lo:cut] else hi == lo,
              f"stream: a poll stops at {hi}, not after the last complete record")
        _need((df is None and expect == 0) or (df is not None and len(df) == expect),
              f"stream: a poll of {0 if df is None else len(df)} records, {expect} appended")
    _need(polls[-1][2] == len(host), "stream: the last poll stops short of the file's end")
    return g1_equal(concat([p[0] for p in polls if p[0] is not None], ignore_index=True),
                    frames["g1"], "G1 through the stream consumer")


PLAIN = {
    "g1_json_write": _plain_json_write,
    "g1_json_read": _plain_g1_read("G1 from NDJSON"),
    **{f"g1_{q}_json": _plain_question(q, "NDJSON") for q in ("q1", "q2", "q3", "q4", "q5")},
    "g1_json_records": _plain_records,
    "taxi_orc_write_snappy": _plain_size,
    "taxi_orc_read_snappy": _plain_same("taxi"),
    "taxi_orc_write_zlib": _plain_size,
    "taxi_orc_read_zlib": _plain_same("taxi"),
    "g1_orc_write": _plain_size,
    "g1_orc_read": _plain_orc_g1,
    "g1_q3_orc": _plain_question("q3", "ORC"),
    "g1_avro_null_read": _plain_g1_read("G1 from Avro (null)", 0),
    "g1_avro_deflate_read": _plain_g1_read("G1 from Avro (deflate)", 0),
    "g1_q1_avro": _plain_question("q1", "Avro"),
    "g1_tpudf_write": _plain_size,
    "g1_tpudf_read": _plain_same("g1"),
    "g1_text": _plain_text,
    "g1_stream": _plain_stream,
}
NEEDS = {name: [] for name in REQUESTS}
NEEDS.update({"g1_q1_json": iop.ONEHOT, "g1_q4_json": iop.ONEHOT, "g1_q3_json": iop.RADIX,
              "g1_q5_json": iop.RADIX, "g1_q3_orc": iop.RADIX, "g1_q1_avro": iop.ONEHOT})
ROUTE = {name: "native" for name in REQUESTS}
