"""The port's text analysis (`index/analysis.py`, `index/analysis_lang.py`)
against the reference's on the same seeded strings (ASCII words, accented
Latin, Cyrillic, Greek, CJK, digits, apostrophes and punctuation): every
built-in and language analyzer, and analyzers built from `index.analysis`
settings, give the same tokens (term, position, start and end offset);
and the reference's 400s for unknown components."""

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import (
    IllegalArgumentError as RefIllegalArgument,
)
from elasticsearch_tpu.index.analysis import AnalysisRegistry as RefRegistry
from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.index.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.index.mapping import MapperService

PIECES = [
    "The", "quick", "brown", "foxes", "jumped", "running", "nationalization",
    "isn't", "don’t", "l'avion", "CAFÉ", "naïve", "über", "Straße", "niño",
    "Ελληνικά", "русский", "текст", "東京", "大学", "の", "日本語",
    "한국어", "中文分词", "2024", "3.14", "e-mail", "C++", "x_y", "  ",
    ",", ".", "!", "?", "(", ")", "—", "…", "\t", "\n", "ABC123", "fi",
    "ｆｕｌｌ", "①", "Mr.", "U.S.A.", "#tag", "@user", "<b>", "&amp;",
    "the", "and", "of", "les", "der", "und", "el", "la",
]


def _texts(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = rng.choice(PIECES, int(rng.integers(1, 24)))
        seps = rng.choice([" ", " ", " ", "", ", ", "-", "/", "  "],
                          len(words))
        out.append("".join(w + s for w, s in zip(words, seps)))
    return out + ["", "   ", "!!!", "東京大学の日本語", "don't STOP me"]


TEXTS = _texts(11, 40)


def _tokens(analyzer, text):
    return [tuple(t) for t in analyzer.analyze(text)]


@pytest.mark.parametrize("name", RefRegistry().names())
def test_every_registered_analyzer_matches_reference(name):
    ref, port = RefRegistry().get(name), AnalysisRegistry().get(name)
    for text in TEXTS:
        assert _tokens(port, text) == _tokens(ref, text), (name, text)


def test_same_analyzer_names():
    assert AnalysisRegistry().names() == RefRegistry().names()
    assert len(RefRegistry().names()) > 6       # language analyzers too


CUSTOM = {
    "index.analysis.analyzer.folded.type": "custom",
    "index.analysis.analyzer.folded.tokenizer": "standard",
    "index.analysis.analyzer.folded.filter": [
        "lowercase", "asciifolding", "my_stop", "my_stem"],
    "index.analysis.analyzer.grams.tokenizer": "my_ngram",
    "index.analysis.analyzer.grams.filter": ["lowercase"],
    "index.analysis.analyzer.edges.tokenizer": "my_edge",
    "index.analysis.analyzer.pat.tokenizer": "my_pattern",
    "index.analysis.analyzer.pat.filter": "lowercase, unique",
    "index.analysis.analyzer.syn.tokenizer": "whitespace",
    "index.analysis.analyzer.syn.filter": ["lowercase", "my_syn"],
    "index.analysis.analyzer.shingles.tokenizer": "standard",
    "index.analysis.analyzer.shingles.filter": ["lowercase", "my_shingle",
                                                "my_len", "my_trunc"],
    "index.analysis.analyzer.std_stop.type": "standard",
    "index.analysis.analyzer.std_stop.stopwords": ["the", "and"],
    "index.analysis.analyzer.fr.tokenizer": "standard",
    "index.analysis.analyzer.fr.filter": ["elision", "lowercase",
                                          "fr_stem", "icu_folding"],
    "index.analysis.analyzer.cjk2.tokenizer": "cjk",
    "index.analysis.analyzer.phon.tokenizer": "standard",
    "index.analysis.analyzer.phon.filter": ["lowercase", "my_phon"],
    "index.analysis.analyzer.repl.tokenizer": "keyword",
    "index.analysis.analyzer.repl.filter": ["my_repl", "uppercase"],
    "index.analysis.tokenizer.my_ngram.type": "ngram",
    "index.analysis.tokenizer.my_ngram.min_gram": 2,
    "index.analysis.tokenizer.my_ngram.max_gram": 3,
    "index.analysis.tokenizer.my_edge.type": "edge_ngram",
    "index.analysis.tokenizer.my_edge.max_gram": 4,
    "index.analysis.tokenizer.my_pattern.type": "pattern",
    "index.analysis.tokenizer.my_pattern.pattern": "[,/ ]+",
    "index.analysis.filter.my_stop.type": "stop",
    "index.analysis.filter.my_stop.stopwords": "_english_",
    "index.analysis.filter.my_stem.type": "stemmer",
    "index.analysis.filter.my_stem.language": "english",
    "index.analysis.filter.fr_stem.type": "stemmer",
    "index.analysis.filter.fr_stem.language": "french",
    "index.analysis.filter.my_syn.type": "synonym",
    "index.analysis.filter.my_syn.synonyms": ["quick, fast", "fox => vixen"],
    "index.analysis.filter.my_shingle.type": "shingle",
    "index.analysis.filter.my_shingle.max_shingle_size": 3,
    "index.analysis.filter.my_len.type": "length",
    "index.analysis.filter.my_len.min": 2,
    "index.analysis.filter.my_trunc.type": "truncate",
    "index.analysis.filter.my_trunc.length": 6,
    "index.analysis.filter.my_phon.type": "phonetic",
    "index.analysis.filter.my_phon.encoder": "soundex",
    "index.analysis.filter.my_repl.type": "pattern_replace",
    "index.analysis.filter.my_repl.pattern": "[aeiou]",
    "index.analysis.filter.my_repl.replacement": "*",
}


@pytest.mark.parametrize("name", sorted({k.split(".")[3] for k in CUSTOM
                                         if ".analyzer." in k}))
def test_custom_analyzers_from_settings_match_reference(name):
    ref = RefRegistry.from_index_settings(CUSTOM).get(name)
    port = AnalysisRegistry.from_index_settings(CUSTOM).get(name)
    for text in TEXTS:
        assert _tokens(port, text) == _tokens(ref, text), (name, text)


@pytest.mark.parametrize("settings", [
    {"index.analysis.analyzer.a.tokenizer": "nope"},
    {"index.analysis.analyzer.a.tokenizer": "standard",
     "index.analysis.analyzer.a.filter": ["nope"]},
    {"index.analysis.analyzer.a.type": "standard",
     "index.analysis.analyzer.a.stopwords": "_klingon_"},
    {"index.analysis.filter.f.min_gram": 2},
])
def test_bad_analysis_settings_are_the_reference_errors(settings):
    with pytest.raises(RefIllegalArgument) as want:
        RefRegistry.from_index_settings(settings)
    with pytest.raises(IllegalArgumentError) as got:
        AnalysisRegistry.from_index_settings(settings)
    assert got.value.message == want.value.message


def test_text_mapper_uses_the_index_analyzers():
    """A text field's analyzer and search_analyzer come from the index's
    registry; an unknown analyzer is the reference's 400."""
    reg = AnalysisRegistry.from_index_settings(CUSTOM)
    ms = MapperService({"properties": {
        "a": {"type": "text", "analyzer": "folded"},
        "b": {"type": "text", "analyzer": "english",
              "search_analyzer": "standard"}}}, registry=reg)
    parsed = ms.parse_document({"a": "The Cafés running", "b": ["dogs", "x"]})
    assert parsed.terms["a"] == ["cafe", "run"]
    assert parsed.term_positions["a"] == [1, 2]
    assert parsed.field_lengths == {"a": 2, "b": 2}
    assert parsed.terms["b"] == ["dog", "x"]
    assert parsed.term_positions["b"] == [0, 1]
    assert ms.get("b").search_analyzer.terms("dogs") == ["dogs"]
    with pytest.raises(IllegalArgumentError, match="failed to find analyzer"):
        MapperService({"properties": {"c": {"type": "text",
                                            "analyzer": "nope"}}})
