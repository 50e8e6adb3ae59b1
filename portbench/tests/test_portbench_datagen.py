"""The generators against their datagen scripts' column domains."""

import json

import torch

from portbench.datagen import common, groupby, join
from portbench.tests.conftest import ROOT, SMALL


def config(name):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    cfg.update(SMALL[name])
    return cfg


def strings(d):
    chars = bytes(d.chars.tolist())
    offs = d.offsets.tolist()
    return [chars[a:b].decode() for a, b in zip(offs, offs[1:])]


def test_groupby_domains():
    cfg = config("G1_1e8_1e2_0_0")
    n, k = cfg["N"], cfg["K"]
    d = groupby.generate(cfg, 2 ** 40 + 1, "cpu")
    x = d.tables["x"]
    assert list(x) == ["id1", "id2", "id3", "id4", "id5", "id6", "v1", "v2", "v3"]
    for c, hi in (("id4", k), ("id5", k), ("id6", n // k), ("v1", 5), ("v2", 15)):
        assert x[c].dtype == torch.int32
        assert int(x[c].min()) >= 1 and int(x[c].max()) <= hi
    assert x["v3"].dtype == torch.float64 and 0 <= float(x["v3"].min()) < float(
        x["v3"].max()) < 100
    assert torch.equal(x["v3"], torch.round(x["v3"], decimals=6))
    for c, hi, width in (("id1", k, 3), ("id2", k, 3), ("id3", n // k, 10)):
        keys = strings(d.dicts["x"][c])
        assert keys == sorted(keys) and len(set(keys)) == len(keys)
        assert all(len(s) == 2 + width and s.startswith("id") for s in keys)
        v = d.values("x", c)
        assert int(v.min()) >= 1 and int(v.max()) <= hi
        # each code spells its row's number
        assert [keys[i] for i in x[c][:50].tolist()] == [f"id{i:0{width}d}" for i in
                                                        v[:50].tolist()]


def test_join_tables_and_keys():
    cfg = config("J1_1e8_NA_0_0")
    n, levels = cfg["N"], cfg["levels"]
    d = join.generate(cfg, 2 ** 40 + 2, "cpu")
    assert {f: list(t) for f, t in d.tables.items()} == {
        "x": ["id1", "id2", "id3", "id4", "id5", "id6", "v1"],
        "small": ["id1", "id4", "v2"], "medium": ["id1", "id2", "id4", "id5", "v2"],
        "big": ["id1", "id2", "id3", "id4", "id5", "id6", "v2"]}
    assert [d.rows(f) for f in ("x", "small", "medium", "big")] == [n] + levels
    # the right key of each question is distinct; x's id3 too (N keys, N rows)
    for frame, c in (("small", "id1"), ("medium", "id2"), ("big", "id3"), ("x", "id3")):
        assert torch.unique(d.tables[frame][c]).numel() == d.rows(frame)
    for frame in d.tables:
        for i in (1, 2, 3):
            if f"id{i}" in d.tables[frame]:
                keys = strings(d.dicts[frame][f"id{i + 3}"])
                assert keys == sorted(keys)
                assert torch.equal(d.values(frame, f"id{i + 3}"), d.tables[frame][f"id{i}"].long())
    # about 90% of x's rows find a match at each level
    for i, right in ((1, "small"), (2, "medium"), (3, "big")):
        hit = torch.isin(d.tables["x"][f"id{i}"], d.tables[right][f"id{i}"]).double().mean()
        assert 0.85 < float(hit) < 0.95
    assert 0 <= float(d.tables["x"]["v1"].min()) and float(d.tables["x"]["v1"].max()) < 100


def test_seed_repeats_and_large_seeds():
    cfg = config("G1_1e8_1e2_0_0")
    a = groupby.generate(cfg, 2 ** 33 + 5, "cpu").tables["x"]
    b = groupby.generate(cfg, 2 ** 33 + 5, "cpu").tables["x"]
    c = groupby.generate(cfg, 2 ** 33 + 6, "cpu").tables["x"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["v3"], c["v3"])


def test_id_dictionary_sorts_as_strings_and_parses_back():
    v = torch.tensor([1, 10, 2, 100, 9, 11, 110, 1000000])
    keys, d = common.id_dictionary(v)
    assert strings(d) == sorted(f"id{i}" for i in v.tolist())
    assert torch.equal(d.numbers(), keys)
    bad = torch.tensor(list(b"idx1id12ab"), dtype=torch.uint8)
    assert common.parse_ids(bad, torch.tensor([0, 4, 8, 10])).tolist() == [-1, 12, -1]
