"""PTB-style tokenizer, pure Python (echr_tpu/metrics/tokenizer.py, the
port's copy, the same behaviour).

The reference tokenizes through coco-caption's PTBTokenizer, a Stanford
CoreNLP **Java** subprocess (reference: evaluate.py:14,232-233; the
submodule/jar is not vendored in the snapshot), invoked with
`-preserveLines -lowerCase` and followed by a punctuation-token filter.
This is a host-side, off-hot-path re-implementation of its observable
behavior on caption text:

- lowercase (the jar's -lowerCase flag);
- Stanford clitic/possessive splitting: "man's" -> `man 's`,
  "don't" -> `do n't`, "won't" -> `wo n't`, "they'll" -> `they 'll`,
  plus 're 've 'd 'm; trailing plural possessives ("dogs'") leave a lone
  `'` that the punctuation filter removes, like the jar;
- Stanford assimilation splits: cannot -> `can not`, gonna -> `gon na`,
  gotta, lemme, gimme, wanna;
- special-cased single tokens the jar keeps whole: o'clock, y'all;
- hyphenated words, number commas/periods, and word-internal slashes stay
  single tokens ("twenty-one", "1,000", "3.5", "and/or" — the jar's
  ptb3Escaping writes the last as `and\\/or`; we keep it unescaped, a
  bijective renaming applied to candidates and references alike, so every
  n-gram metric is unchanged);
- symbol tokens the jar emits AND the filter keeps survive as their own
  tokens: `$ % & + = # @ * /` ("100% of the $5 weights" ->
  `100 % of the $ 5 weights`);
- drop the punctuation token list coco-caption filters after tokenizing
  (parentheses never surface: the jar emits them as -LRB-/-RRB-/-LCB-/
  -RCB-, all in the filter list, so silently dropping ( ) { } here is
  equivalent);
- Unicode typography is normalized the way the lexer's ptb3Escaping does:
  curly/prime single quotes -> ' (so a curly-apostrophe "man's" still
  clitic-splits to `man 's`), curly/guillemet double quotes -> " (the jar
  emits ``/'' which coco filters; bare " is dropped here — equivalent),
  en/em/horizontal-bar dashes and minus -> -- (filtered), horizontal
  ellipsis -> ... (filtered), fraction slash -> /, the Unicode space
  family -> ' ', and soft hyphens / zero-width marks are deleted (CoreNLP
  strips them).  Accented and non-Latin letters are word characters like
  the jar's ("café" stays one token, not "caf").

Known residual gap vs the jar (documented, unmeasurable without a
JVM): locale-specific CoreNLP options we do not emulate (americanize
spelling rewrites, Latin-ligature expansion) — rare in caption text and
bijective across candidates/references when they do appear.
"""
from __future__ import annotations

import re
from typing import Dict, List

# ---------------------------------------------------------------------------
# ptb3Escaping-style typography normalization, applied before lexing
# (Stanford PTBLexer quote/dash/ellipsis handling; CoreNLP strips
# control/invisible marks).  Multi-char targets need str.replace; single
# chars ride one str.translate table.
# ---------------------------------------------------------------------------
_TYPO_MULTI = [
    ("…", "..."),                       # horizontal ellipsis
    ("–", "--"), ("—", "--"),      # en / em dash
    ("―", "--"), ("−", "--"),      # horizontal bar / minus sign
]
_TYPO_TABLE = str.maketrans({
    # single-quote family -> ' (keeps clitic/possessive splitting live)
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "′": "'", "ʼ": "'", "´": "'",
    # double-quote family -> " (the jar's ``/'' are both coco-filtered; a
    # bare " is dropped by the lexer regex below — same net output)
    "“": '"', "”": '"', "„": '"', "‟": '"',
    "″": '"', "«": '"', "»": '"',
    # fraction slash joins digits exactly like an ASCII slash ("1/2")
    "⁄": "/",
    # Unicode space family -> plain space
    **{chr(c): " " for c in (
        [0x00A0, 0x1680, 0x202F, 0x205F, 0x3000]
        + list(range(0x2000, 0x200B))        # en/em/thin/hair/... spaces
    )},
    # soft hyphen and zero-width marks: deleted, not split points
    "­": None, "​": None, "‌": None, "‍": None,
    "﻿": None,
})


def _normalize_typography(s: str) -> str:
    for src, dst in _TYPO_MULTI:
        if src in s:
            s = s.replace(src, dst)
    return s.translate(_TYPO_TABLE)


# coco-caption PTBTokenizer removes exactly these tokens after tokenizing
PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

# Stanford PTBLexer assimilation splits (splitAssimilations, on by default)
_ASSIMILATIONS = {
    "cannot": ("can", "not"),
    "gonna": ("gon", "na"),
    "gotta": ("got", "ta"),
    "lemme": ("lem", "me"),
    "gimme": ("gim", "me"),
    "wanna": ("wan", "na"),
}

# words the lexer keeps whole despite containing an apostrophe
_APOSTROPHE_WHOLE = {"o'clock", "y'all", "ma'am"}

# word chars may be joined by - . , ' / when flanked by alphanumerics
# (twenty-one, 3.5, 1,000, it's, and/or); symbol tokens the jar keeps
# ($ % & + = # @ * and a lone /) are emitted standalone; everything else
# splits.  [^\W_] = Unicode alphanumerics minus underscore, so accented
# words ("café") stay whole like the jar's.
_WORD_RE = re.compile(
    r"[^\W_]+(?:[-.,'/][^\W_]+)*|\.\.\.|--|[$%&+=#@*/]|[.,?!:;`\-]|''|``|'"
)

# clitics peeled off the END of a word token, innermost last ("he'd've"
# -> he 'd 've); n't covers don't/won't/can't -> do/wo/ca + n't
_CLITIC_RE = re.compile(r"(?:n't|'(?:s|ll|re|ve|d|m))$")


def _split_word(w: str) -> List[str]:
    if w in _APOSTROPHE_WHOLE:
        return [w]
    if w in _ASSIMILATIONS:
        return list(_ASSIMILATIONS[w])
    clitics: List[str] = []
    while True:
        m = _CLITIC_RE.search(w)
        # never strip a word down to nothing ("'s" alone stays "'s")
        if not m or m.start() == 0:
            break
        clitics.append(w[m.start():])
        w = w[: m.start()]
    return [w] + clitics[::-1]


def tokenize_caption(s: str) -> str:
    s = _normalize_typography(s).lower().replace("\n", " ")
    toks: List[str] = []
    for raw in _WORD_RE.findall(s):
        toks.extend(_split_word(raw) if raw[0].isalnum() or "'" in raw else [raw])
    return " ".join(tk for tk in toks if tk not in PUNCTUATIONS)


def tokenize(captions: Dict[int, List[Dict[str, str]]]) -> Dict[int, List[str]]:
    """coco-style interface: {idx: [{'caption': str}]} -> {idx: [str]}."""
    return {
        k: [tokenize_caption(item["caption"]) for item in v]
        for k, v in captions.items()
    }
