"""Language analysis (the port's copy of
`elasticsearch_tpu/index/analysis_lang.py`, whole): the analyzers the reference ships in
`modules/analysis-common` (language analyzers built from stopwords +
snowball stemmers) and the `plugins/analysis-{icu,phonetic,kuromoji,nori,
smartcn,...}` plugins (SURVEY.md §2.12).

Design notes, not ports:
- Language analyzers are stopword set + light suffix stemmer per language
  (the reference composes Lucene's stop + SnowballFilter the same way);
  stemmer rules here are compact light-stemming variants, not full
  snowball — BM25 ranking only needs consistent conflation.
- `cjk` does Han/Kana/Hangul bigramming, which is also the
  dictionary-free behavior the CJK plugins degrade to; kuromoji/nori/
  smartcn register as aliases of it so mappings written for the plugins
  resolve.
- `icu_folding` = NFKC + accent strip + case fold (the common 99% of
  ICU folding); `phonetic` provides soundex and metaphone-lite encoders.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Iterable, List

from elasticsearch_tpu_torch.index.analysis import (
    Analyzer,
    Token,
    letter_tokenizer,
    lowercase_filter,
    standard_tokenizer,
    stop_filter,
)

# ---------------------------------------------------------------------------
# stopword sets (standard public lists, abbreviated to the high-frequency
# core — enough for scoring parity on common text)
# ---------------------------------------------------------------------------

STOPWORDS = {
    "french": frozenset(
        "au aux avec ce ces dans de des du elle en et eux il ils je la le les "
        "leur lui ma mais me même mes moi mon ne nos notre nous on ou par pas "
        "pour qu que qui sa se ses son sur ta te tes toi ton tu un une vos "
        "votre vous c d j l à m n s t y été être".split()),
    "german": frozenset(
        "aber alle als also am an auch auf aus bei bin bis bist da damit das "
        "dass dein der den des dem die dies doch dort du durch ein eine einem "
        "einen einer eines er es für hatte hier ich ihr im in ist ja kann "
        "mein mit muss nach nicht noch nun nur oder sehr sich sie sind so "
        "um und uns unter vom von vor war was wie wir zu zum zur über".split()),
    "spanish": frozenset(
        "a al algo como con de del desde donde el ella ellas ellos en entre "
        "era es esa ese eso esta este esto fue ha hay la las le les lo los "
        "me mi mis muy más ni no nos o os para pero por que se ser si sin "
        "sobre su sus te tu un una uno y ya él".split()),
    "italian": frozenset(
        "a ad al alla alle anche che chi ci come con da dal dalla de dei del "
        "della delle di e ed era fra gli ha ho i il in io la le lei lo loro "
        "lui ma mi ne nei nel nella no noi non nostro o per piú più quella "
        "quello questa questo se si sono su sua sue sui sul sulla suo tra tu "
        "un una uno voi è".split()),
    "portuguese": frozenset(
        "a ao aos as até com como da das de dela dele deles do dos e ela elas "
        "ele eles em entre era essa esse esta este eu foi há isso isto já la "
        "lhe mais mas me mesmo meu minha muito na nas no nos nossa nosso não "
        "o os ou para pela pelo por qual quando que se sem ser seu sua são "
        "também te tem um uma você à às é".split()),
    "dutch": frozenset(
        "aan al alles als altijd andere ben bij daar dan dat de der deze die "
        "dit doch doen door dus een en er ge geen geweest haar had heb hebben "
        "heeft hem het hier hij hoe hun iemand iets ik in is ja je kan kon "
        "kunnen maar me meer men met mij mijn moet na naar niet niets nog nu "
        "of om omdat onder ons ook op over reeds te tegen toch toen tot u uit "
        "uw van veel voor want waren was wat werd wezen wie wil worden wordt "
        "zal ze zelf zich zij zijn zo zonder zou".split()),
    "russian": frozenset(
        "а без более бы был была были было быть в вам вас весь во вот все "
        "всего всех вы где да даже для до его ее если есть еще же за здесь и "
        "из или им их к как ко когда кто ли либо мне может мы на надо наш не "
        "него нее нет ни них но ну о об однако он она они оно от очень по "
        "под при с со так также такой там те тем то того тоже той только том "
        "ты у уже хотя чего чей чем что чтобы чье чья эта эти это я".split()),
    "swedish": frozenset(
        "alla att av blev bli blir de dem den denna deras dess det detta dig "
        "din dina ditt du där då efter ej eller en er era ett från för ha "
        "hade han hans har hon hos hur här i icke ingen inom inte jag ju kan "
        "kunde man med mellan men mig min mina mitt mot mycket ni nu när "
        "någon något några och om oss på samma sedan sig sin sina sitta "
        "själv skulle som så sådan till under upp ut utan vad var vara varför "
        "varit varje vars vem vi vid vilken än är åt över".split()),
    "norwegian": frozenset(
        "alle at av bare begge ble da de dem den denne der deres det dette "
        "din disse du eller en enn er et for fra få ha hadde han hans har "
        "hennes her hun hva hvem hver hvilken hvis hvor hvordan hvorfor i "
        "ikke ingen inn jeg kan kom kun kunne man mange med meg mellom men "
        "mer min mitt mot noe noen nå når og også om opp oss over på samme "
        "seg selv sin sine sitt skal skulle slik som store så til um under "
        "ut uten var ved vi vil ville vår være vært".split()),
    "danish": frozenset(
        "af alle alt anden at blev blive bliver da de dem den denne der deres "
        "det dette dig din disse dog du efter eller en end er et for fra ham "
        "han hans har havde have hende hendes her hos hun hvad hvis hvor i "
        "ikke ind jeg jer jo kunne man mange med meget men mig min mine mit "
        "mod ned noget nogle nu når og også om op os over på selv sig sin "
        "sine sit skal skulle som sådan thi til ud under var vi vil ville "
        "vor være været".split()),
    "finnish": frozenset(
        "ei eivät emme en et ette että he hän häneen hänellä hänelle häneltä "
        "hänen hänessä hänestä hänet ja jos joka jotka kanssa keiden ketkä "
        "koska kuin kuinka kun me minkä minua minulla minulle minulta minun "
        "minussa minusta minut minä mitkä mukaan mutta ne niin nyt näiden "
        "nämä ole olemme olen olet olette oli olimme olin olisi olit olitte "
        "olivat olla olleet ollut on ovat poikki se sekä sen siinä siitä "
        "sille sillä silti sinua sinulla sinulle sinulta sinun sinussa "
        "sinusta sinut sinä tai te tämä tässä tästä tähän vaan vai vaikka yli "
        "ylös".split()),
}

# light suffix-stripping rules per language: longest match wins, applied to
# lowercase terms above a minimum stem length
_STEM_RULES = {
    "french": ["issements", "issement", "atrices", "atrice", "ateurs",
               "ations", "ateur", "ation", "ements", "ement", "euses",
               "ences", "ance", "ence", "euse", "eurs", "eaux", "ives",
               "eur", "ive", "aux", "ées", "és", "ée", "es", "er", "ez",
               "s", "e"],
    "german": ["erinnen", "erin", "ern", "em", "er", "en", "es", "e", "s"],
    "spanish": ["amientos", "imientos", "amiento", "imiento", "aciones",
                "uciones", "adoras", "adores", "ancias", "acion", "ucion",
                "adora", "ador", "ante", "anza", "ible", "able", "ista",
                "oso", "osa", "es", "os", "as", "o", "a", "e"],
    "italian": ["azioni", "azione", "amenti", "imenti", "amento", "imento",
                "atrice", "atori", "anza", "enza", "ante", "ibili", "abili",
                "ista", "oso", "osa", "i", "e", "o", "a"],
    "portuguese": ["amentos", "imentos", "amento", "imento", "adoras",
                   "adores", "aço~es", "ações", "ismos", "istas", "adora",
                   "ação", "ador", "ante", "ável", "ível", "eza", "ico",
                   "ica", "oso", "osa", "es", "os", "as", "o", "a", "e"],
    "dutch": ["heden", "ingen", "eren", "end", "ing", "en", "se", "s", "e"],
    "russian": ["иями", "ями", "ами", "иях", "ях", "ах", "ией", "ей", "ой",
                "ий", "ия", "ие", "ые", "ое", "ая", "яя", "ет", "ют", "ит",
                "ат", "ть", "ы", "и", "а", "я", "о", "е", "у", "ю", "ь"],
    "swedish": ["heterna", "heten", "arna", "erna", "orna", "ande", "ende",
                "aste", "arne", "or", "ar", "er", "en", "et", "a", "e"],
    "norwegian": ["hetene", "heten", "ande", "ende", "edes", "ene", "ane",
                  "ete", "et", "en", "ar", "er", "as", "es", "a", "e", "s"],
    "danish": ["erendes", "erende", "hedens", "ernes", "erens", "heden",
               "erne", "eren", "erer", "heds", "enes", "eres", "ens", "ene",
               "ere", "en", "er", "es", "et", "e", "s"],
    "finnish": ["issa", "issä", "ista", "istä", "iksi", "illa", "illä",
                "ilta", "iltä", "ille", "ssa", "ssä", "sta", "stä", "lla",
                "llä", "lta", "ltä", "lle", "ksi", "in", "en", "an", "än",
                "on", "a", "ä", "n", "t"],
}


def light_stemmer(language: str, min_stem: int = 3):
    rules = sorted(_STEM_RULES[language], key=len, reverse=True)

    def stem(word: str) -> str:
        for suf in rules:
            if word.endswith(suf) and len(word) - len(suf) >= min_stem:
                return word[: -len(suf)]
        return word

    def apply(tokens: Iterable[Token]) -> List[Token]:
        return [t._replace(term=stem(t.term)) for t in tokens]

    return apply


def elision_filter(tokens: Iterable[Token]) -> List[Token]:
    """French/Italian articles: l'avion -> avion (reference: ElisionFilter)."""
    out = []
    for t in tokens:
        term = t.term
        for apo in ("'", "’"):
            if apo in term:
                head, _, tail = term.partition(apo)
                if len(head) <= 2 and tail:
                    term = tail
                break
        out.append(t._replace(term=term))
    return out


# ---------------------------------------------------------------------------
# CJK bigrams (reference: `cjk` analyzer; the dictionary plugins
# kuromoji/nori/smartcn alias onto it here)
# ---------------------------------------------------------------------------

def _is_cjk(ch: str) -> bool:
    code = ord(ch)
    return (0x4E00 <= code <= 0x9FFF      # CJK unified
            or 0x3400 <= code <= 0x4DBF   # ext A
            or 0x3040 <= code <= 0x30FF   # hiragana + katakana
            or 0xAC00 <= code <= 0xD7AF   # hangul
            or 0xF900 <= code <= 0xFAFF)  # compatibility ideographs


def cjk_tokenizer(text: str) -> List[Token]:
    """Bigrams over CJK runs; non-CJK words tokenize like standard."""
    out: List[Token] = []
    pos = 0
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if _is_cjk(ch):
            j = i
            while j < n and _is_cjk(text[j]):
                j += 1
            run = text[i:j]
            if len(run) == 1:
                out.append(Token(run, pos, i, j))
                pos += 1
            else:
                for kk in range(len(run) - 1):
                    out.append(Token(run[kk:kk + 2], pos, i + kk, i + kk + 2))
                    pos += 1
            i = j
        elif ch.isalnum():
            j = i
            while j < n and text[j].isalnum() and not _is_cjk(text[j]):
                j += 1
            out.append(Token(text[i:j].lower(), pos, i, j))
            pos += 1
            i = j
        else:
            i += 1
    return out


# ---------------------------------------------------------------------------
# ICU folding (reference: plugins/analysis-icu ICUFoldingFilter)
# ---------------------------------------------------------------------------

def icu_folding_filter(tokens: Iterable[Token]) -> List[Token]:
    def fold(s: str) -> str:
        s = unicodedata.normalize("NFKC", s)
        s = "".join(c for c in unicodedata.normalize("NFKD", s)
                    if not unicodedata.combining(c))
        return s.casefold()

    return [t._replace(term=fold(t.term)) for t in tokens]


# ---------------------------------------------------------------------------
# Phonetic (reference: plugins/analysis-phonetic)
# ---------------------------------------------------------------------------

_SOUNDEX_CODES = {**{c: "1" for c in "bfpv"}, **{c: "2" for c in "cgjkqsxz"},
                  **{c: "3" for c in "dt"}, "l": "4",
                  **{c: "5" for c in "mn"}, "r": "6"}


def soundex(word: str) -> str:
    word = re.sub(r"[^a-z]", "", word.lower())
    if not word:
        return ""
    out = word[0].upper()
    prev = _SOUNDEX_CODES.get(word[0], "")
    for ch in word[1:]:
        code = _SOUNDEX_CODES.get(ch, "")
        if code and code != prev:
            out += code
            if len(out) == 4:
                break
        if ch not in "hw":
            prev = code
    return (out + "000")[:4]


def metaphone(word: str) -> str:
    """Compact metaphone variant: consonant-class folding."""
    w = re.sub(r"[^a-z]", "", word.lower())
    if not w:
        return ""
    subs = [("ph", "f"), ("gh", "g"), ("ck", "k"), ("sch", "sk"),
            ("th", "0"), ("sh", "x"), ("ch", "x"), ("dg", "j"),
            ("qu", "kw"), ("wh", "w")]
    for a, b in subs:
        w = w.replace(a, b)
    w = re.sub(r"(.)\1+", r"\1", w)          # dedupe doubles
    head, rest = w[0], w[1:]
    rest = re.sub(r"[aeiouy]", "", rest)     # drop interior vowels
    w = head + rest
    w = w.replace("c", "k").replace("q", "k").replace("z", "s")
    return w[:6].upper()


def phonetic_filter(encoder: str = "metaphone", replace: bool = True):
    enc = soundex if encoder == "soundex" else metaphone

    def apply(tokens: Iterable[Token]) -> List[Token]:
        out = []
        for t in tokens:
            code = enc(t.term)
            if not code:
                out.append(t)
                continue
            out.append(t._replace(term=code))
            if not replace:
                out.append(t)
        return out

    return apply


# ---------------------------------------------------------------------------
# generic filters the reference ships in analysis-common
# ---------------------------------------------------------------------------

def shingle_filter(min_size: int = 2, max_size: int = 2,
                   output_unigrams: bool = True):
    def apply(tokens: Iterable[Token]) -> List[Token]:
        toks = list(tokens)
        out = list(toks) if output_unigrams else []
        for n in range(min_size, max_size + 1):
            for i in range(len(toks) - n + 1):
                grp = toks[i:i + n]
                out.append(Token(" ".join(t.term for t in grp),
                                 grp[0].position, grp[0].start_offset,
                                 grp[-1].end_offset))
        return out

    return apply


def edge_ngram_filter(min_gram: int = 1, max_gram: int = 10):
    def apply(tokens: Iterable[Token]) -> List[Token]:
        out = []
        for t in tokens:
            for n in range(min_gram, min(max_gram, len(t.term)) + 1):
                out.append(t._replace(term=t.term[:n]))
        return out

    return apply


def ngram_filter(min_gram: int = 1, max_gram: int = 2):
    def apply(tokens: Iterable[Token]) -> List[Token]:
        out = []
        for t in tokens:
            for n in range(min_gram, max_gram + 1):
                for i in range(max(0, len(t.term) - n + 1)):
                    out.append(t._replace(term=t.term[i:i + n]))
        return out

    return apply


def synonym_filter(synonyms: List[str]):
    """Solr-format rules: "a, b => c" (rewrite) or "a, b, c" (expand)."""
    rewrite = {}
    expand = {}
    for rule in synonyms:
        if "=>" in rule:
            lhs, _, rhs = rule.partition("=>")
            target = rhs.strip().split(",")[0].strip()
            for term in lhs.split(","):
                rewrite[term.strip()] = target
        else:
            group = [t.strip() for t in rule.split(",") if t.strip()]
            for term in group:
                expand.setdefault(term, group)

    def apply(tokens: Iterable[Token]) -> List[Token]:
        out = []
        for t in tokens:
            if t.term in rewrite:
                out.append(t._replace(term=rewrite[t.term]))
            elif t.term in expand:
                for alt in expand[t.term]:
                    out.append(t._replace(term=alt))
            else:
                out.append(t)
        return out

    return apply


def trim_filter(tokens: Iterable[Token]) -> List[Token]:
    return [t._replace(term=t.term.strip()) for t in tokens]


def truncate_filter(length: int = 10):
    def apply(tokens: Iterable[Token]) -> List[Token]:
        return [t._replace(term=t.term[:length]) for t in tokens]

    return apply


def unique_filter(tokens: Iterable[Token]) -> List[Token]:
    seen = set()
    out = []
    for t in tokens:
        if t.term not in seen:
            seen.add(t.term)
            out.append(t)
    return out


def reverse_filter(tokens: Iterable[Token]) -> List[Token]:
    return [t._replace(term=t.term[::-1]) for t in tokens]


def length_filter(min_len: int = 0, max_len: int = 255):
    def apply(tokens: Iterable[Token]) -> List[Token]:
        return [t for t in tokens if min_len <= len(t.term) <= max_len]

    return apply


def stemmer_filter(language: str = "english"):
    if language in ("english", "porter", "porter2", "light_english"):
        from elasticsearch_tpu_torch.index.analysis import porter_stem_filter
        return porter_stem_filter
    base = language.replace("light_", "")
    if base in _STEM_RULES:
        return light_stemmer(base)
    from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
    raise IllegalArgumentError(f"unknown stemmer language [{language}]")


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def language_analyzers() -> List[Analyzer]:
    out = []
    for lang, stops in STOPWORDS.items():
        filters = [lowercase_filter]
        if lang in ("french", "italian"):
            filters.append(elision_filter)
        filters.append(stop_filter(stops))
        filters.append(light_stemmer(lang))
        out.append(Analyzer(lang, standard_tokenizer, filters))
    cjk = Analyzer("cjk", cjk_tokenizer, [])
    out.append(cjk)
    # dictionary-analyzer plugins resolve to the bigram analyzer
    for alias in ("kuromoji", "nori", "smartcn"):
        out.append(Analyzer(alias, cjk_tokenizer, []))
    out.append(Analyzer("icu_analyzer", standard_tokenizer,
                        [icu_folding_filter]))
    out.append(Analyzer("arabic", standard_tokenizer,
                        [lowercase_filter]))
    out.append(Analyzer("fingerprint", letter_tokenizer,
                        [lowercase_filter, unique_filter]))
    return out
