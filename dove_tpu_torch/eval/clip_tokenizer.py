"""CLIP's byte-level BPE tokenizer, read from a checkpoint's own files.

What ``transformers.CLIPTokenizer.from_pretrained(dir)`` computes when
``ftfy`` is absent, without ``transformers`` or ``regex``: the text is
cleaned as its BasicTokenizer cleans it (control characters dropped,
whitespace collapsed, spaces around CJK ideographs, NFC, lower case), split
into words by CLIP's pattern, each word's UTF-8 bytes mapped to printable
characters and merged by the ranks of ``merges.txt`` (whose first line is a
header), then wrapped in ``<|startoftext|>`` ... ``<|endoftext|>`` and padded
to ``max_length`` with the checkpoint's pad token.

The pattern is CLIP's with ``re`` classes: ``[^\\W\\d_]+`` for letters and
``\\d`` for numbers, where CLIP's ``regex`` pattern has ``\\p{L}`` and
``\\p{N}``. The two agree on every character but the numerals outside Nd
(such as superscript digits), which ``re`` counts as letters.
"""

from __future__ import annotations

import functools
import json
import re
import unicodedata
from pathlib import Path

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"

_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d"
    r"|(?:[^\s\w]|_)+",
    re.IGNORECASE)
_SPECIAL = re.compile(r"(<\|startoftext\|>|<\|endoftext\|>)")
# the merges CLIP reads: 49152 - 256 - 2 lines after the header
_MAX_MERGES = 49152 - 256 - 2


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


def clean_text(text: str) -> str:
    """The cleaning of transformers' BasicTokenizer(strip_accents=False,
    do_split_on_punc=False), joined by single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp in (0, 0xFFFD) or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


def _pad_token(tok_dir: Path) -> str:
    """The checkpoint's pad token: special_tokens_map.json, then
    tokenizer_config.json, else CLIP's default (the end token)."""
    for name in ("special_tokens_map.json", "tokenizer_config.json"):
        path = tok_dir / name
        if path.exists():
            pad = json.loads(path.read_text(encoding="utf-8")).get("pad_token")
            if isinstance(pad, dict):
                pad = pad.get("content")
            if pad:
                return pad
    return EOS


class CLIPTokenizer:
    """Token ids of CLIP's tokenizer from ``vocab.json`` and ``merges.txt``."""

    def __init__(self, vocab_file, merges_file, pad_token: str = EOS):
        self.encoder: dict[str, int] = json.loads(
            Path(vocab_file).read_text(encoding="utf-8"))
        lines = Path(merges_file).read_text(encoding="utf-8").strip().split("\n")
        merges = [tuple(line.split()) for line in lines[1:_MAX_MERGES + 1]]
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.pad_token = pad_token
        self._cache = {BOS: BOS, EOS: EOS}

    @classmethod
    def from_dir(cls, tok_dir) -> "CLIPTokenizer":
        tok_dir = Path(tok_dir)
        return cls(tok_dir / "vocab.json", tok_dir / "merges.txt", _pad_token(tok_dir))

    def _id(self, token: str) -> int:
        return self.encoder.get(token, self.encoder.get(EOS))

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word[:-1], word[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        """BPE tokens of one string, the special tokens kept whole."""
        tokens = []
        for piece in _SPECIAL.split(text):
            if piece in (BOS, EOS):
                tokens.append(piece)
                continue
            for word in _PATTERN.findall(clean_text(piece)):
                mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                tokens.extend(self.bpe(mapped).split(" "))
        return tokens

    def encode(self, text: str) -> list[int]:
        return [self._id(BOS)] + [self._id(t) for t in self.tokenize(text)] + [self._id(EOS)]

    def __call__(self, texts: list[str], max_length: int) -> list[list[int]]:
        """Each text's ids padded with the pad token to ``max_length`` (a
        longer one is kept whole, as transformers keeps it without
        ``truncation``)."""
        pad = self._id(self.pad_token)
        return [ids + [pad] * (max_length - len(ids)) for ids in map(self.encode, texts)]


def write_bpe_files(tok_dir, words, vocab_size: int | None = None) -> int:
    """Write a small ``vocab.json`` and ``merges.txt`` in CLIP's format
    whose merges spell each of ``words`` (lower case) as one token, for
    seeded checkpoints: the 512 byte tokens, the merges' tokens, then the
    start and end tokens, the end token the highest id (at ``vocab_size``
    - 1 when given, as in CLIP's own vocabulary). Returns the vocabulary's
    size."""
    tok_dir = Path(tok_dir)
    tok_dir.mkdir(parents=True, exist_ok=True)
    base = list(bytes_to_unicode().values())
    vocab = base + [c + "</w>" for c in base]
    merges = []
    for word in words:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            merges.append(f"{parts[0]} {parts[1]}")
            parts = [parts[0] + parts[1]] + parts[2:]
            if parts[0] not in vocab:
                vocab.append(parts[0])
    size = vocab_size or len(vocab) + 2
    if size < len(vocab) + 2:
        raise ValueError(f"vocab_size {size} below the {len(vocab) + 2} tokens")
    ids = {tok: i for i, tok in enumerate(vocab)}
    ids[BOS], ids[EOS] = size - 2, size - 1
    (tok_dir / "vocab.json").write_text(json.dumps(ids), encoding="utf-8")
    (tok_dir / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(dict.fromkeys(merges)) + "\n", encoding="utf-8")
    return size
