"""``cudf_tpu_torch.ops.text`` against the reference's ``cudf_tpu.ops.text``
(JAX on the CPU), exact, function by function: null rows, empty rows,
non-ASCII text and the whitespace Python's ``str.split()`` takes (tabs,
\\x1c-\\x1f, U+00A0, U+3000) included.  The device functions
(``count_tokens``, ``tokenize``, n-grams, ``minhash``, Jaccard,
``normalize_spaces``, the vocabulary lookup) take no host route; the
host functions count theirs in ``HOST_ROUTES``.  Follows
``tests/test_text_aux.py``."""

import numpy as np
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.core.column import Column as RC
from cudf_tpu.ops import text as rtext

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import text
from cudf_tpu_torch.ops._utils import HOST_ROUTES

torch.set_num_threads(1)

CPU = "cpu"


def _strings(n, seed):
    rng = np.random.default_rng(seed)
    alpha = list("abcd xy_") + ["é", "漢", " ", "\t", "\n", "\x1c", " ", "　", "  "]
    out = ["".join(rng.choice(alpha, rng.integers(0, 30))) for _ in range(n)]
    out[0], out[1], out[2] = None, "", "  lead and trail  "
    out[3] = "y" * 40
    return out


def _pair(n=200, seed=0):
    s = _strings(n, seed)
    return RC.from_strings(s), Column.from_strings(s, device=CPU)


def _same(got, exp):
    g, e = got.to_pylist(), exp.to_pylist()
    if g and isinstance(e[0] if e[0] is not None else e[-1], float):
        np.testing.assert_allclose(np.array(g, float), np.array(e, float), rtol=0,
                                   equal_nan=True)
    else:
        assert g == e


DEVICE = {
    "count_tokens": (lambda m, c, o: m.count_tokens(c)),
    "count_tokens_delimiter": (lambda m, c, o: m.count_tokens(c, "a")),
    "tokenize": (lambda m, c, o: m.tokenize(c)),
    "tokenize_delimiter": (lambda m, c, o: m.tokenize(c, "b")),
    "tokenize_two_byte_delimiter": (lambda m, c, o: m.tokenize(c, "é")),
    "character_ngrams_1": (lambda m, c, o: m.character_ngrams(c, 1)),
    "character_ngrams_2": (lambda m, c, o: m.character_ngrams(c, 2)),
    "character_ngrams_5": (lambda m, c, o: m.character_ngrams(c, 5)),
    "ngrams_tokenize_2": (lambda m, c, o: m.ngrams_tokenize(c, 2)),
    "ngrams_tokenize_3_sep": (lambda m, c, o: m.ngrams_tokenize(c, 3, "::")),
    "minhash_4": (lambda m, c, o: m.minhash(c, np.array([0, 7, 2 ** 63 + 3], np.uint64), 4)),
    "minhash_1": (lambda m, c, o: m.minhash(c, np.array([11], np.uint64), 1)),
    "jaccard_4": (lambda m, c, o: m.jaccard_index(c, o, 4)),
    "jaccard_2": (lambda m, c, o: m.jaccard_index(c, o, 2)),
    "normalize_spaces": (lambda m, c, o: m.normalize_spaces(c)),
}


@pytest.mark.parametrize("name", list(DEVICE))
def test_device_text_functions_equal_the_reference(name):
    (ra, pa), (rb, pb) = _pair(seed=1), _pair(seed=2)
    before = dict(HOST_ROUTES)
    got = DEVICE[name](text, pa, pb)
    assert HOST_ROUTES == before
    _same(got, DEVICE[name](rtext, ra, rb))


def test_chunked_text_functions_equal_whole_ones(monkeypatch):
    """Per-byte work is done a chunk of rows at a time: the results do not
    depend on where the chunks are cut."""
    _, pa = _pair(500, 3)
    whole = [text.count_tokens(pa), text.tokenize(pa), text.normalize_spaces(pa),
             text.minhash(pa, [1, 2], 3), text.jaccard_index(pa, pa, 3)]
    monkeypatch.setattr(text, "CHUNK_BYTES", 64)
    cut = [text.count_tokens(pa), text.tokenize(pa), text.normalize_spaces(pa),
           text.minhash(pa, [1, 2], 3), text.jaccard_index(pa, pa, 3)]
    for a, b in zip(whole, cut):
        _same(a, b)


def test_tokenize_with_vocabulary_equals_the_reference():
    (ra, pa) = _pair(seed=4)
    vocab = ["a", "b", "xy", "é", "a", "漢漢", ""]
    got = text.tokenize_with_vocabulary(pa, Column.from_strings(vocab, device=CPU))
    _same(got, rtext.tokenize_with_vocabulary(ra, RC.from_strings(vocab)))
    got = text.tokenize_with_vocabulary(pa, Column.from_strings(vocab, device=CPU), "c", 99)
    _same(got, rtext.tokenize_with_vocabulary(ra, RC.from_strings(vocab), "c", 99))


HOST = {
    "edit_distance": (lambda m, c, o: m.edit_distance(c, o)),
    "porter_stemmer_measure": (lambda m, c, o: m.porter_stemmer_measure(c)),
    "wordpiece_tokenize": (lambda m, c, o: m.wordpiece_tokenize(
        c, {"a": 0, "##b": 1, "ab": 2, "x": 3, "[UNK]": 4}, max_tokens=5)),
    "byte_pair_encoding": (lambda m, c, o: m.byte_pair_encoding(c, [("a", "b"), ("ab", "c"),
                                                                     ("x", "y")])),
}


@pytest.mark.parametrize("name", list(HOST))
def test_host_text_functions_equal_the_reference_and_count_their_route(name):
    (ra, pa), (rb, pb) = _pair(seed=5), _pair(seed=6)
    before = sum(HOST_ROUTES.values())
    got = HOST[name](text, pa, pb)
    assert sum(HOST_ROUTES.values()) > before
    _same(got, HOST[name](rtext, ra, rb))


def test_empty_column():
    empty = Column.from_strings(["", None], device=CPU)
    assert text.count_tokens(empty).to_pylist() == [0, None]
    assert text.tokenize(empty).to_pylist() == []
    assert text.minhash(empty, [1, 2]).to_pylist() == [[0, 0], [0, 0]]
    assert text.normalize_spaces(empty).to_pylist() == ["", None]
