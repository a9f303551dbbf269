"""QA answer-string matching evaluation (DPR heritage).

The counterpart of ``convdr_tpu/evaluation/qa_eval.py``; parity with the
reference's utils/dpr_utils.py:224-333: checks whether retrieved passages
contain any gold answer string by sliding token-window match over
regex-tokenized, NFD-normalized, lowercased text. Unused by the ConvDR
drivers upstream but part of the DPR evaluation surface (open-domain QA hit@k
over retrieved contexts).

The tokenizer needs the ``regex`` package (its ``\\p{...}`` Unicode classes,
which the stdlib ``re`` lacks). It is imported at first use, and without it
:class:`SimpleTokenizer` raises; no other pattern stands in for it.
"""

from __future__ import annotations

import functools
import unicodedata
from typing import List, Sequence

_ALPHA_NUM = r"[\p{L}\p{N}\p{M}]+"
_NON_WS = r"[^\p{Z}\p{C}]"


@functools.lru_cache(maxsize=None)
def _token_re():
    try:
        import regex
    except ImportError as e:
        raise ImportError(
            "qa_eval's SimpleTokenizer needs the 'regex' package (its \\p{...} "
            "Unicode classes), which is not installed"
        ) from e
    return regex.compile(
        f"({_ALPHA_NUM})|({_NON_WS})",
        flags=regex.IGNORECASE + regex.UNICODE + regex.MULTILINE,
    )


def _normalize(text: str) -> str:
    return unicodedata.normalize("NFD", text)


class SimpleTokenizer:
    """Regex word/non-whitespace tokenizer (dpr_utils.py:259-278)."""

    def tokenize(self, text: str) -> "Tokens":
        return Tokens([m.group() for m in _token_re().finditer(text)])


class Tokens:
    def __init__(self, words: List[str]):
        self._words = words

    def __len__(self) -> int:
        return len(self._words)

    def words(self, uncased: bool = False) -> List[str]:
        if uncased:
            return [w.lower() for w in self._words]
        return list(self._words)


def has_answer(
    answers: Sequence[str], text: str, tokenizer: SimpleTokenizer = None
) -> bool:
    """True if any answer string token-matches a window of the text."""
    if text is None:
        return False
    tokenizer = tokenizer or SimpleTokenizer()
    words = tokenizer.tokenize(_normalize(text)).words(uncased=True)
    for answer in answers:
        ans = tokenizer.tokenize(_normalize(answer)).words(uncased=True)
        if not ans:
            continue
        for i in range(0, len(words) - len(ans) + 1):
            if ans == words[i : i + len(ans)]:
                return True
    return False


def check_answer(
    passages, answers: Sequence[str], doc_ids: Sequence[int],
    tokenizer: SimpleTokenizer = None,
) -> List[bool]:
    """Per retrieved doc: does its text contain any gold answer?

    ``passages`` maps doc_id -> text (or (text, title) tuples like the
    reference's DPR passage db).
    """
    tokenizer = tokenizer or SimpleTokenizer()
    hits = []
    for doc_id in doc_ids:
        entry = passages[doc_id]
        text = entry[0] if isinstance(entry, (tuple, list)) else entry
        hits.append(has_answer(answers, text, tokenizer))
    return hits


def hit_at_k(hits: Sequence[bool], k: int) -> bool:
    """Open-domain QA hit@k: any of the top-k docs contains an answer."""
    return any(hits[:k])
