"""Text analysis: analyzers, tokenizers, token filters (the port's copy
of `elasticsearch_tpu/index/analysis.py`, whole: the same terms,
positions and offsets for every analyzer).

Re-design of the reference's analysis registry (`index/analysis/`,
`modules/analysis-common/` — SURVEY.md §2.4): a small pluggable registry of
named analyzers built from tokenizer + filter chains. Covers the built-in
analyzers the core API surface needs (standard, simple, whitespace, keyword,
stop, english) — language plugins can register more.

Analysis is host-side by design: it feeds the inverted index, which stays on
host; only scoring-relevant statistics cross to the device.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError


class Token(NamedTuple):
    term: str
    position: int
    start_offset: int
    end_offset: int


# ---------------------------------------------------------------------------
# Tokenizers
# ---------------------------------------------------------------------------

_WORD_RE = re.compile(r"[^\W_]+(?:['’][^\W_]+)?", re.UNICODE)
_WHITESPACE_RE = re.compile(r"\S+")
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)


# Token(...) through tuple.__new__: the same tuples without the named
# tuple's Python-level constructor, which dominated indexing a corpus
_new_token = tuple.__new__


def _regex_tokenizer(pattern: re.Pattern) -> Callable[[str], List[Token]]:
    def tokenize(text: str) -> List[Token]:
        return [_new_token(Token, (m.group(0), i) + m.span())
                for i, m in enumerate(pattern.finditer(text))]

    return tokenize


standard_tokenizer = _regex_tokenizer(_WORD_RE)     # unicode word segmentation (approx UAX#29)
whitespace_tokenizer = _regex_tokenizer(_WHITESPACE_RE)
letter_tokenizer = _regex_tokenizer(_LETTER_RE)


def keyword_tokenizer(text: str) -> List[Token]:
    return [Token(text, 0, 0, len(text))] if text else []


def ngram_tokenizer(min_gram: int = 1, max_gram: int = 2) -> Callable[[str], List[Token]]:
    def tokenize(text: str) -> List[Token]:
        out = []
        pos = 0
        for n in range(min_gram, max_gram + 1):
            for i in range(0, max(0, len(text) - n + 1)):
                out.append(Token(text[i:i + n], pos, i, i + n))
                pos += 1
        return out

    return tokenize


def edge_ngram_tokenizer(min_gram: int = 1, max_gram: int = 10) -> Callable[[str], List[Token]]:
    def tokenize(text: str) -> List[Token]:
        return [Token(text[:n], 0, 0, n)
                for n in range(min_gram, min(max_gram, len(text)) + 1)]

    return tokenize


# ---------------------------------------------------------------------------
# Token filters
# ---------------------------------------------------------------------------

ENGLISH_STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split()
)


def lowercase_filter(tokens: Iterable[Token]) -> List[Token]:
    return [_new_token(Token, (t[0].lower(),) + t[1:]) for t in tokens]


def asciifolding_filter(tokens: Iterable[Token]) -> List[Token]:
    def fold(s: str) -> str:
        return "".join(c for c in unicodedata.normalize("NFKD", s)
                       if not unicodedata.combining(c))

    return [t._replace(term=fold(t.term)) for t in tokens]


def stop_filter(stopwords: frozenset = ENGLISH_STOPWORDS):
    def apply(tokens: Iterable[Token]) -> List[Token]:
        return [t for t in tokens if t.term not in stopwords]

    return apply


def _porter_stem(word: str) -> str:
    """Porter stemmer (reference uses Lucene's PorterStemFilter for 'english').

    Compact implementation of the classic algorithm, steps 1-5.
    """
    if len(word) <= 2:
        return word

    vowels = "aeiou"

    def is_cons(w, i):
        c = w[i]
        if c in vowels:
            return False
        if c == "y":
            return i == 0 or not is_cons(w, i - 1)
        return True

    def measure(w):
        m, prev_v = 0, False
        for i in range(len(w)):
            v = not is_cons(w, i)
            if prev_v and not v:
                m += 1
            prev_v = v
        return m

    def has_vowel(w):
        return any(not is_cons(w, i) for i in range(len(w)))

    def ends_double_cons(w):
        return len(w) >= 2 and w[-1] == w[-2] and is_cons(w, len(w) - 1)

    def cvc(w):
        if len(w) < 3:
            return False
        return (is_cons(w, len(w) - 3) and not is_cons(w, len(w) - 2)
                and is_cons(w, len(w) - 1) and w[-1] not in "wxy")

    w = word

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # step 1b
    if w.endswith("eed"):
        if measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif ends_double_cons(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif measure(w) == 1 and cvc(w):
                w += "e"

    # step 1c
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    step2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
             ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
             ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
             ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
             ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble")]
    for suf, rep in step2:
        if w.endswith(suf):
            if measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 3
    step3 = [("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
             ("ical", "ic"), ("ful", ""), ("ness", "")]
    for suf, rep in step3:
        if w.endswith(suf):
            if measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 4
    step4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
             "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize"]
    for suf in step4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if suf == "ent" and w.endswith(("sion", "tion")):
                # 'ion' handled below
                pass
            if measure(stem) > 1:
                if suf in ("ate",) or True:
                    w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and measure(w[:-3]) > 1:
            w = w[:-3]

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = measure(stem)
        if m > 1 or (m == 1 and not cvc(stem)):
            w = stem
    # step 5b
    if measure(w) > 1 and ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w


def porter_stem_filter(tokens: Iterable[Token]) -> List[Token]:
    return [t._replace(term=_porter_stem(t.term)) for t in tokens]


# ---------------------------------------------------------------------------
# Analyzer
# ---------------------------------------------------------------------------

class Analyzer:
    def __init__(self, name: str, tokenizer: Callable[[str], List[Token]],
                 filters: Iterable[Callable[[Iterable[Token]], List[Token]]] = ()):
        self.name = name
        self.tokenizer = tokenizer
        self.filters = list(filters)

    def analyze(self, text: str) -> List[Token]:
        tokens = self.tokenizer(str(text))
        for f in self.filters:
            tokens = f(tokens)
        return tokens

    def terms(self, text: str) -> List[str]:
        return [t.term for t in self.analyze(text)]


class AnalysisRegistry:
    """Named analyzers per index (reference: AnalysisRegistry.java)."""

    def __init__(self):
        self._analyzers: Dict[str, Analyzer] = {}
        for a in built_in_analyzers():
            self._analyzers[a.name] = a
        from elasticsearch_tpu_torch.index.analysis_lang import language_analyzers
        for a in language_analyzers():
            self._analyzers.setdefault(a.name, a)

    def register(self, analyzer: Analyzer) -> None:
        self._analyzers[analyzer.name] = analyzer

    def get(self, name: str) -> Analyzer:
        if name == "default" and "default" not in self._analyzers:
            name = "standard"  # index.analysis.analyzer.default fallback
        a = self._analyzers.get(name)
        if a is None:
            raise IllegalArgumentError(f"failed to find analyzer [{name}]")
        return a

    def names(self):
        return sorted(self._analyzers)

    @classmethod
    def from_index_settings(cls, flat_settings: Dict) -> "AnalysisRegistry":
        """Per-index registry with custom analyzers/tokenizers/filters from
        `index.analysis.*` settings (reference: AnalysisRegistry builds
        per-index components from IndexSettings)."""
        reg = cls()
        analysis = _nest_analysis_settings(flat_settings)
        if not analysis:
            return reg

        custom_tokenizers = {}
        for name, spec in (analysis.get("tokenizer") or {}).items():
            custom_tokenizers[name] = _build_tokenizer(spec)
        custom_filters = {}
        for name, spec in (analysis.get("filter") or {}).items():
            custom_filters[name] = _build_filter(spec)

        for name, spec in (analysis.get("analyzer") or {}).items():
            atype = spec.get("type", "custom")
            if atype != "custom":
                # e.g. {"type": "standard", "stopwords": [...]}: start from
                # the named built-in, override stopwords when given
                base = reg.get(atype)
                filters = list(base.filters)
                if "stopwords" in spec:
                    filters = list(filters) + [
                        stop_filter(_resolve_stopwords(spec["stopwords"]))]
                reg.register(Analyzer(name, base.tokenizer, filters))
                continue
            tok_name = spec.get("tokenizer", "standard")
            tokenizer = custom_tokenizers.get(tok_name) \
                or _builtin_tokenizer(tok_name)
            filters = []
            for f in _as_list(spec.get("filter", [])):
                if f in custom_filters:
                    filters.append(custom_filters[f])
                else:
                    filters.append(_builtin_filter(f))
            reg.register(Analyzer(name, tokenizer, filters))
        return reg


def _as_list(v):
    if isinstance(v, str):
        return [p.strip() for p in v.split(",") if p.strip()]
    return list(v or [])


def _resolve_stopwords(value) -> frozenset:
    """Stopword spec → set; "_lang_" macros resolve to the language list,
    "_none_" disables, unknown macros error (a typo silently becoming the
    English list is invisible data corruption)."""
    if isinstance(value, str) and value.startswith("_") and value.endswith("_"):
        name = value.strip("_")
        if name == "none":
            return frozenset()
        if name == "english":
            return ENGLISH_STOPWORDS
        from elasticsearch_tpu_torch.index.analysis_lang import STOPWORDS
        if name in STOPWORDS:
            return STOPWORDS[name]
        raise IllegalArgumentError(f"failed to find stopwords set [{value}]")
    return frozenset(_as_list(value))


def _nest_analysis_settings(flat: Dict) -> Dict:
    """{"index.analysis.analyzer.my.type": "custom", ...} →
    {"analyzer": {"my": {"type": "custom", ...}}}; list-valued leaves pass
    through (filter: [...])."""
    out: Dict = {}
    for key, value in (flat or {}).items():
        if not key.startswith("index.analysis."):
            continue
        parts = key[len("index.analysis."):].split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def _builtin_tokenizer(name: str):
    table = {
        "standard": standard_tokenizer,
        "whitespace": whitespace_tokenizer,
        "letter": letter_tokenizer,
        "keyword": keyword_tokenizer,
        "lowercase": lambda text: lowercase_filter(letter_tokenizer(text)),
    }
    if name in table:
        return table[name]
    if name == "ngram":
        return ngram_tokenizer()
    if name == "edge_ngram":
        return edge_ngram_tokenizer()
    from elasticsearch_tpu_torch.index.analysis_lang import cjk_tokenizer
    if name in ("cjk", "kuromoji_tokenizer", "nori_tokenizer", "smartcn_tokenizer"):
        return cjk_tokenizer
    raise IllegalArgumentError(f"failed to find tokenizer [{name}]")


def _build_tokenizer(spec: Dict):
    ttype = spec.get("type", "standard")
    if ttype == "ngram":
        return ngram_tokenizer(int(spec.get("min_gram", 1)),
                               int(spec.get("max_gram", 2)))
    if ttype == "edge_ngram":
        return edge_ngram_tokenizer(int(spec.get("min_gram", 1)),
                                    int(spec.get("max_gram", 10)))
    if ttype == "pattern":
        pat = re.compile(spec.get("pattern", r"\W+"))

        def tokenize(text: str, pat=pat):
            # tokens are the gaps between separator matches, with real
            # offsets (highlighting depends on them)
            out = []
            pos = 0
            start = 0
            for m in pat.finditer(text):
                if m.start() > start:
                    out.append(Token(text[start:m.start()], pos, start,
                                     m.start()))
                    pos += 1
                start = max(m.end(), start + 1 if m.end() == m.start()
                            else m.end())
            if start < len(text):
                out.append(Token(text[start:], pos, start, len(text)))
            return out

        return tokenize
    return _builtin_tokenizer(ttype)


def _builtin_filter(name: str):
    from elasticsearch_tpu_torch.index import analysis_lang as lang
    table = {
        "lowercase": lowercase_filter,
        "asciifolding": asciifolding_filter,
        "stop": stop_filter(),
        "porter_stem": porter_stem_filter,
        "stemmer": porter_stem_filter,
        "kstem": porter_stem_filter,
        "snowball": porter_stem_filter,
        "elision": lang.elision_filter,
        "icu_folding": lang.icu_folding_filter,
        "icu_normalizer": lang.icu_folding_filter,
        "trim": lang.trim_filter,
        "unique": lang.unique_filter,
        "reverse": lang.reverse_filter,
        "shingle": lang.shingle_filter(),
        "edge_ngram": lang.edge_ngram_filter(),
        "ngram": lang.ngram_filter(),
        "phonetic": lang.phonetic_filter(),
        "truncate": lang.truncate_filter(),
        "length": lang.length_filter(),
        "classic": lowercase_filter,
        "uppercase": lambda toks: [t._replace(term=t.term.upper())
                                   for t in toks],
        "decimal_digit": lambda toks: [
            t._replace(term="".join(
                str(unicodedata.digit(c)) if c.isdigit() else c
                for c in t.term)) for t in toks],
    }
    if name in table:
        return table[name]
    raise IllegalArgumentError(f"failed to find token filter [{name}]")


def _build_filter(spec: Dict):
    from elasticsearch_tpu_torch.index import analysis_lang as lang
    ftype = spec.get("type")
    if ftype == "stop":
        return stop_filter(_resolve_stopwords(spec.get("stopwords",
                                                       "_english_")))
    if ftype == "stemmer":
        return lang.stemmer_filter(spec.get("language", "english"))
    if ftype == "synonym" or ftype == "synonym_graph":
        return lang.synonym_filter(_as_list(spec.get("synonyms", [])))
    if ftype == "shingle":
        return lang.shingle_filter(
            int(spec.get("min_shingle_size", 2)),
            int(spec.get("max_shingle_size", 2)),
            bool(spec.get("output_unigrams", True)))
    if ftype == "edge_ngram":
        return lang.edge_ngram_filter(int(spec.get("min_gram", 1)),
                                      int(spec.get("max_gram", 10)))
    if ftype == "ngram":
        return lang.ngram_filter(int(spec.get("min_gram", 1)),
                                 int(spec.get("max_gram", 2)))
    if ftype == "phonetic":
        return lang.phonetic_filter(spec.get("encoder", "metaphone"),
                                    bool(spec.get("replace", True)))
    if ftype == "truncate":
        return lang.truncate_filter(int(spec.get("length", 10)))
    if ftype == "length":
        return lang.length_filter(int(spec.get("min", 0)),
                                  int(spec.get("max", 255)))
    if ftype == "pattern_replace":
        pat = re.compile(spec.get("pattern", ""))
        repl = spec.get("replacement", "")
        return lambda toks: [t._replace(term=pat.sub(repl, t.term))
                             for t in toks]
    if ftype:
        return _builtin_filter(ftype)
    raise IllegalArgumentError("token filter definition requires [type]")


def built_in_analyzers() -> List[Analyzer]:
    return [
        Analyzer("standard", standard_tokenizer, [lowercase_filter]),
        Analyzer("simple", letter_tokenizer, [lowercase_filter]),
        Analyzer("whitespace", whitespace_tokenizer),
        Analyzer("keyword", keyword_tokenizer),
        Analyzer("stop", letter_tokenizer, [lowercase_filter, stop_filter()]),
        Analyzer("english", standard_tokenizer,
                 [lowercase_filter, stop_filter(), porter_stem_filter]),
    ]


# DEFAULT_REGISTRY is constructed lazily (PEP 562 module __getattr__):
# building it at import time would re-enter analysis_lang while that module
# is still initializing whenever analysis_lang is imported first.
_default_registry: Optional[AnalysisRegistry] = None


def __getattr__(name: str):
    if name == "DEFAULT_REGISTRY":
        global _default_registry
        if _default_registry is None:
            _default_registry = AnalysisRegistry()
        return _default_registry
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
