"""Self-contained tokenizers: byte-level BPE (RoBERTa) and WordPiece (BERT).

The reference consumes tokenizers from ``transformers==2.3.0`` downloads
(reference utils/util.py:256-277, data/tokenizing.py:90-108). This
framework runs in hermetic environments, so both algorithms are implemented
here and load from local vocabulary files:

  * :class:`ByteLevelBPETokenizer` -- ``vocab.json`` + ``merges.txt``
    (GPT-2/RoBERTa byte-level BPE; special tokens <s> </s> <pad> ...)
  * :class:`WordPieceTokenizer`    -- ``vocab.txt``
    (BERT lowercase WordPiece; [CLS] [SEP] [PAD] [UNK])

Both expose the subset of the HF tokenizer API the pipeline uses: ``tokenize``,
``convert_tokens_to_ids``, ``encode(text, text_pair=..., add_special_tokens=...,
max_length=...)``, ``add_tokens`` (for the ``<response>`` marker,
run_convdr_train.py:472-474), and special-token ids. ``tiny()`` constructors
build deterministic miniature vocabularies for tests.
"""

from __future__ import annotations

import json
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

# GPT-2 style pre-tokenization pattern (contractions, words, numbers,
# punctuation runs, whitespace).
_BPE_REGEX = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)

# Unicode White_Space, which is what ``regex``'s \s matches; stdlib ``re``'s
# \s also takes U+001C..U+001F, so the fallback spells the set out.
_WHITE_SPACE = (
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
)


def _category_class(prefix: str) -> str:
    """A ``re`` character-class body matching every code point whose
    Unicode general category starts with ``prefix`` (``\\p{L}``, ``\\p{N}``)."""
    parts: List[str] = []
    start = prev = None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            parts.append(_range(start, prev))
            start = None
    if start is not None:
        parts.append(_range(start, prev))
    return "".join(parts)


def _range(lo: int, hi: int) -> str:
    esc = lambda cp: f"\\U{cp:08x}"  # noqa: E731
    return esc(lo) if lo == hi else f"{esc(lo)}-{esc(hi)}"


@lru_cache()
def bpe_pattern(use_regex: Optional[bool] = None):
    """The compiled pre-tokenizer. ``regex`` when it imports; otherwise an
    equivalent stdlib ``re`` pattern with the Unicode letter and number
    classes built from :mod:`unicodedata` (takes about a second, once).
    ``use_regex`` forces one or the other (tests compare the two)."""
    if use_regex is None or use_regex:
        try:
            import regex
        except ImportError:
            if use_regex:
                raise
        else:
            return regex.compile(_BPE_REGEX)
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        rf"""'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+"""
        rf"""| ?[^{_WHITE_SPACE}{letters}{numbers}]+"""
        rf"""|[{_WHITE_SPACE}]+(?![^{_WHITE_SPACE}])|[{_WHITE_SPACE}]+"""
    )


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2 byte-level alphabet)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _truncate_longest_first(ids_a, ids_b, budget: int):
    """HF longest_first: repeatedly trim the longer segment's tail."""
    if ids_b is None:
        return ids_a[:budget], None
    a, b = len(ids_a), len(ids_b)
    while a + b > budget:
        # HF truncate_sequences trims the PAIR on ties (`if len(ids) >
        # len(pair_ids): ids.pop() else: pair_ids.pop()`), so strictly-longer
        # is the condition for trimming the first segment.
        if a > b:
            a -= 1
        else:
            b -= 1
    return ids_a[:a], ids_b[:b]


class BaseTokenizer:
    """Shared API: vocab dict + special tokens + added-token extension."""

    cls_token: str
    sep_token: str
    pad_token: str
    unk_token: str

    def __init__(self, vocab: Dict[str, int], model_max_length: int = 512):
        self.vocab: Dict[str, int] = dict(vocab)
        self.ids_to_tokens: Dict[int, str] = {v: k for k, v in self.vocab.items()}
        self.added_tokens: Dict[str, int] = {}
        self.model_max_length = model_max_length

    # -- vocab -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.vocab) + len(self.added_tokens)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def add_tokens(self, tokens: Sequence[str]) -> int:
        added = 0
        for tok in tokens:
            if tok not in self.vocab and tok not in self.added_tokens:
                new_id = len(self)
                self.added_tokens[tok] = new_id
                self.ids_to_tokens[new_id] = tok
                added += 1
        return added

    def token_to_id(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        return self.vocab.get(token, self.vocab[self.unk_token])

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            return self.token_to_id(tokens)
        return [self.token_to_id(t) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    # -- special ids -------------------------------------------------------
    @property
    def cls_token_id(self) -> int:
        return self.vocab[self.cls_token]

    @property
    def sep_token_id(self) -> int:
        return self.vocab[self.sep_token]

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def unk_token_id(self) -> int:
        return self.vocab[self.unk_token]

    # -- encoding ----------------------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        raise NotImplementedError

    def num_special_tokens_pair(self) -> int:
        raise NotImplementedError

    @property
    def max_len_single_sentence(self) -> int:
        raise NotImplementedError

    def _split_on_added(self, text: str) -> List[Tuple[str, bool]]:
        """Split text around added tokens (which must survive verbatim)."""
        if not self.added_tokens:
            return [(text, False)]
        pieces: List[Tuple[str, bool]] = [(text, False)]
        # Longest token first, deterministically: when one added token is a
        # substring of another (e.g. "<response>" / "<response_long>"), the
        # longer must win, matching HF's trie-based longest-match semantics.
        for tok in sorted(self.added_tokens, key=lambda t: (-len(t), t)):
            nxt: List[Tuple[str, bool]] = []
            for piece, is_tok in pieces:
                if is_tok:
                    nxt.append((piece, True))
                    continue
                parts = piece.split(tok)
                for i, part in enumerate(parts):
                    if part:
                        nxt.append((part, False))
                    if i < len(parts) - 1:
                        nxt.append((tok, True))
            pieces = nxt
        return pieces

    def _tokenize_with_added(self, text: str) -> List[str]:
        out: List[str] = []
        for piece, is_tok in self._split_on_added(text):
            if is_tok:
                out.append(piece)
            else:
                out.extend(self.tokenize(piece))
        return out

    def encode(
        self,
        text: str,
        text_pair: Optional[str] = None,
        add_special_tokens: bool = True,
        max_length: Optional[int] = None,
    ) -> List[int]:
        ids_a = self.convert_tokens_to_ids(self._tokenize_with_added(text))
        ids_b = (
            self.convert_tokens_to_ids(self._tokenize_with_added(text_pair))
            if text_pair is not None
            else None
        )
        if max_length is not None and add_special_tokens:
            # HF longest_first truncation: shrink the longer segment one
            # token at a time until the assembled sequence fits, keeping the
            # special-token structure intact (the naive "chop the built
            # sequence" would drop the pair separators entirely).
            num_special = (
                self.num_special_tokens_pair() if ids_b is not None else 2
            )
            budget = max(max_length - num_special, 0)
            ids_a, ids_b = _truncate_longest_first(ids_a, ids_b, budget)
        ids = self.build_inputs(ids_a, ids_b) if add_special_tokens else (
            ids_a + (ids_b or [])
        )
        if max_length is not None and len(ids) > max_length:
            ids = ids[:max_length]
        return ids

    def build_inputs(self, ids_a: List[int], ids_b: Optional[List[int]]) -> List[int]:
        raise NotImplementedError


class ByteLevelBPETokenizer(BaseTokenizer):
    """RoBERTa-style byte-level BPE. Sequence layout: <s> A </s> (</s> B </s>)."""

    cls_token = "<s>"
    sep_token = "</s>"
    pad_token = "<pad>"
    unk_token = "<unk>"

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        model_max_length: int = 512,
    ):
        super().__init__(vocab, model_max_length)
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "ByteLevelBPETokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        tok = cls(vocab, merges, **kw)
        added_path = os.path.join(path, "added_tokens.json")
        if os.path.exists(added_path):
            with open(added_path, encoding="utf-8") as f:
                for t in json.load(f):
                    tok.add_tokens([t])
        return tok

    @classmethod
    def tiny(cls, model_max_length: int = 512) -> "ByteLevelBPETokenizer":
        """Deterministic char-level vocab over the byte alphabet (no merges)."""
        specials = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
        alphabet = sorted(set(bytes_to_unicode().values()))
        vocab = {t: i for i, t in enumerate(specials + alphabet)}
        return cls(vocab, merges=[], model_max_length=model_max_length)

    # -- BPE core ----------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token)
        if len(word) <= 1:
            self._cache[token] = list(word)
            return list(word)
        while True:
            pairs = _get_pairs(word)
            if not pairs:
                break
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
        out = list(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        for piece in bpe_pattern().findall(text):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            tokens.extend(self._bpe(mapped))
        return tokens

    def build_inputs(self, ids_a: List[int], ids_b: Optional[List[int]]) -> List[int]:
        cls_id, sep_id = self.cls_token_id, self.sep_token_id
        if ids_b is None:
            return [cls_id] + ids_a + [sep_id]
        return [cls_id] + ids_a + [sep_id, sep_id] + ids_b + [sep_id]

    def num_special_tokens_pair(self) -> int:
        return 4

    @property
    def max_len_single_sentence(self) -> int:
        return self.model_max_length - 2

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        merges = sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in merges:
                f.write(f"{a} {b}\n")
        if self.added_tokens:
            with open(os.path.join(path, "added_tokens.json"), "w") as f:
                json.dump(list(self.added_tokens), f)


class WordPieceTokenizer(BaseTokenizer):
    """BERT-style lowercase WordPiece. Layout: [CLS] A [SEP] (B [SEP])."""

    cls_token = "[CLS]"
    sep_token = "[SEP]"
    pad_token = "[PAD]"
    unk_token = "[UNK]"

    def __init__(
        self,
        vocab: Dict[str, int],
        do_lower_case: bool = True,
        model_max_length: int = 512,
        max_chars_per_word: int = 100,
    ):
        super().__init__(vocab, model_max_length)
        self.do_lower_case = do_lower_case
        self.max_chars_per_word = max_chars_per_word

    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab_file = path if path.endswith(".txt") else os.path.join(path, "vocab.txt")
        vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        tok = cls(vocab, **kw)
        added_path = os.path.join(os.path.dirname(vocab_file), "added_tokens.json")
        if os.path.exists(added_path):
            with open(added_path, encoding="utf-8") as f:
                for t in json.load(f):
                    tok.add_tokens([t])
        return tok

    @classmethod
    def tiny(cls, model_max_length: int = 512) -> "WordPieceTokenizer":
        """Char-level WordPiece vocab over ascii (a-z, digits, punct)."""
        specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        chars = [chr(c) for c in range(ord("a"), ord("z") + 1)]
        digits = [str(d) for d in range(10)]
        punct = list(".,?!'\"-:;()[]")
        conts = ["##" + c for c in chars + digits]
        vocab = {t: i for i, t in enumerate(specials + chars + digits + punct + conts)}
        return cls(vocab, model_max_length=model_max_length)

    # -- basic + wordpiece -------------------------------------------------
    @staticmethod
    def _is_punct(ch: str) -> bool:
        cp = ord(ch)
        if (
            33 <= cp <= 47
            or 58 <= cp <= 64
            or 91 <= cp <= 96
            or 123 <= cp <= 126
        ):
            return True
        import unicodedata

        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_cjk(ch: str) -> bool:
        """CJK ideograph ranges split char-by-char (BERT basic tokenizer)."""
        cp = ord(ch)
        return (
            0x4E00 <= cp <= 0x9FFF
            or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F
        )

    @staticmethod
    def _clean_text(text: str) -> str:
        """HF BasicTokenizer._clean_text: drop control/format chars and the
        replacement char, normalize exotic whitespace to spaces."""
        import unicodedata

        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD:
                continue
            cat = unicodedata.category(ch)
            if cat.startswith("C") and ch not in ("\t", "\n", "\r"):
                continue
            if cat == "Zs" or ch in ("\t", "\n", "\r"):
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> List[str]:
        import unicodedata

        text = self._clean_text(text)
        if self.do_lower_case:
            text = text.lower()
            text = unicodedata.normalize("NFD", text)
            text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out: List[str] = []
        word: List[str] = []

        def flush():
            if word:
                out.append("".join(word))
                word.clear()

        for ch in text:
            if ch.isspace():
                flush()
            elif self._is_punct(ch) or self._is_cjk(ch):
                flush()
                out.append(ch)
            else:
                word.append(ch)
        flush()
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        for word in self._basic_tokenize(text):
            tokens.extend(self._wordpiece(word))
        return tokens

    def build_inputs(self, ids_a: List[int], ids_b: Optional[List[int]]) -> List[int]:
        cls_id, sep_id = self.cls_token_id, self.sep_token_id
        if ids_b is None:
            return [cls_id] + ids_a + [sep_id]
        return [cls_id] + ids_a + [sep_id] + ids_b + [sep_id]

    def num_special_tokens_pair(self) -> int:
        return 3

    @property
    def max_len_single_sentence(self) -> int:
        return self.model_max_length - 2

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        inv = sorted(self.vocab.items(), key=lambda kv: kv[1])
        with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
            for tok, _ in inv:
                f.write(tok + "\n")
        if self.added_tokens:
            with open(os.path.join(path, "added_tokens.json"), "w") as f:
                json.dump(list(self.added_tokens), f)


def load_tokenizer(kind: str, path_or_tiny: str = "tiny", **kw):
    """Factory: kind in {"roberta", "bert"}; path to vocab dir or "tiny"."""
    cls = ByteLevelBPETokenizer if kind == "roberta" else WordPieceTokenizer
    if path_or_tiny == "tiny":
        return cls.tiny(**kw)
    return cls.from_pretrained(path_or_tiny, **kw)
