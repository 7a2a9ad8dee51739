"""CLIP byte-pair-encoding tokenizer, implemented from scratch.

The port's own copy of ``celebbasis_tpu/text/tokenizer.py`` (pure Python and
numpy; the port imports nothing of the JAX package).  Same behaviour as
HuggingFace's ``CLIPTokenizer`` for ``openai/clip-vit-large-patch14`` with
``max_length=77, padding="max_length", truncation=True``, without a
transformers dependency and offline:

* lower-cased, whitespace-collapsed text, split by the CLIP token regex;
* each word's UTF-8 bytes mapped through the GPT-2 ``bytes_to_unicode`` table,
  with ``</w>`` appended to the final symbol;
* greedy BPE merges by rank;
* specials ``<|startoftext|>`` (49406) / ``<|endoftext|>`` (49407); sequences
  padded with the end token — matching CLIP's pad_token == eos.

Vocab sources (``CLIPTokenizer.load``): HF-format ``vocab.json``+``merges.txt``
directory, or the original OpenAI ``bpe_simple_vocab_16e6.txt.gz``.  When no
vocab files are available (fully offline test environments),
``SyntheticVocab`` builds a deterministic merge-free byte-level vocab with the
same special-token layout so the rest of the stack is exercisable.
"""
from __future__ import annotations

import gzip
import html
import json
import os
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

import re
import unicodedata

import numpy as np

try:                      # third-party `regex` knows \p{L} / \p{N}
    import regex as _regex
except ImportError:       # stdlib fallback below gives the same split
    _regex = None

_TOKEN_SRC = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
              r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")
_TOKEN_PAT = (_regex.compile(_TOKEN_SRC, _regex.IGNORECASE)
              if _regex is not None else None)
# The same pattern for stdlib `re`, over a "shadow" of the text in which every
# non-ASCII letter is 'a', every non-ASCII number '0', every other non-ASCII
# character '#' (or ' ' for whitespace): character classes by Unicode category
# become ASCII classes, and match spans carry over one to one.
_SHADOW_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[a-z]+|[0-9]|[^\sa-z0-9]+""", re.IGNORECASE | re.ASCII)
_WS = re.compile(r"\s+")


def _shadow_char(c: str) -> str:
    if c < "\x80":
        return c
    cat = unicodedata.category(c)[0]
    if cat == "L":
        return "a"
    if cat == "N":
        return "0"
    return " " if c.isspace() else "#"


def _find_tokens_stdlib(text: str) -> List[str]:
    shadow = "".join(map(_shadow_char, text))
    return [text[m.start():m.end()] for m in _SHADOW_PAT.finditer(shadow)]


def find_tokens(text: str) -> List[str]:
    """Split cleaned, lower-cased text by CLIP's token pattern."""
    if _TOKEN_PAT is not None:
        return _TOKEN_PAT.findall(text)
    return _find_tokens_stdlib(text)

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode-char mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return _WS.sub(" ", text).strip()


class SyntheticVocab:
    """Deterministic whole-word fallback vocab (offline environments).

    Layout mirrors CLIP: char tokens, then ``</w>`` char tokens, then a
    *filler* region, then SOT/EOT last — so special ids sit at
    ``size-2``/``size-1`` like the real 49406/49407 when ``size=49408``.

    The filler region is a deterministic word-token space: every word is
    registered as ONE token (slot = sha1(word) mod n_filler, linear probing).
    This keeps the reference's single-token placeholder contract intact
    offline — 'sks' is one token, and injection can never fire on
    sub-tokens inside ordinary words.  Canonical words (placeholders + the
    celeb-name files) are pre-registered at construction in a fixed order
    so token ids are stable across processes.
    """

    def __init__(self, size: int = 49408):
        if size < 514:
            raise ValueError("synthetic vocab needs >= 514 entries "
                             "(512 byte tokens + SOT/EOT)")
        byte_vocab = list(bytes_to_unicode().values())
        tokens = byte_vocab + [c + "</w>" for c in byte_vocab]
        self.filler_base = len(tokens)                      # 512
        self.n_filler = size - len(tokens) - 2
        self.encoder = {tok: i for i, tok in enumerate(tokens)}
        self.encoder[SOT] = size - 2
        self.encoder[EOT] = size - 1
        self.bpe_ranks: Dict[Tuple[str, str], int] = {}


class CLIPTokenizer:
    """From-scratch CLIP BPE tokenizer with the reference's 77-token contract."""

    def __init__(self, encoder: Dict[str, int],
                 bpe_ranks: Dict[Tuple[str, str], int],
                 max_length: int = 77):
        self.encoder = dict(encoder)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(bpe_ranks)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.max_length = max_length
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self.is_synthetic = False  # set by CLIPTokenizer.synthetic()
        self._cache: Dict[str, List[str]] = {SOT: [SOT], EOT: [EOT]}
        # synthetic-vocab word registry (set up by .synthetic())
        self._filler_base = 0
        self._n_filler = 0
        self._declared_size = len(self.encoder)
        self._filler_owner: Dict[int, str] = {}

    # -- constructors -----------------------------------------------------
    @classmethod
    def load(cls, path: str, max_length: int = 77) -> "CLIPTokenizer":
        """Load from an HF tokenizer dir, a vocab.json file, or an OpenAI bpe gz."""
        if os.path.isdir(path):
            vocab_file = os.path.join(path, "vocab.json")
            merges_file = os.path.join(path, "merges.txt")
            return cls.from_hf_files(vocab_file, merges_file, max_length)
        if path.endswith(".gz"):
            return cls.from_openai_bpe(path, max_length)
        if path.endswith("vocab.json"):
            merges = os.path.join(os.path.dirname(path), "merges.txt")
            return cls.from_hf_files(path, merges, max_length)
        raise ValueError(f"unrecognized vocab path: {path}")

    @classmethod
    def from_hf_files(cls, vocab_file: str, merges_file: str,
                      max_length: int = 77) -> "CLIPTokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            encoder = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version") and len(l.split()) == 2]
        ranks = {m: i for i, m in enumerate(merges)}
        return cls(encoder, ranks, max_length)

    @classmethod
    def from_openai_bpe(cls, bpe_gz_path: str, max_length: int = 77) -> "CLIPTokenizer":
        with gzip.open(bpe_gz_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merge_lines]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend([SOT, EOT])
        encoder = {tok: i for i, tok in enumerate(vocab)}
        ranks = {m: i for i, m in enumerate(merges)}
        return cls(encoder, ranks, max_length)

    @classmethod
    def synthetic(cls, size: int = 49408, max_length: int = 77,
                  prime_words: Sequence[str] | None = None) -> "CLIPTokenizer":
        sv = SyntheticVocab(size)
        tok = cls(sv.encoder, sv.bpe_ranks, max_length)
        tok.is_synthetic = True
        tok._filler_base = sv.filler_base
        tok._n_filler = sv.n_filler
        tok._declared_size = size
        words = (_canonical_prime_words() if prime_words is None
                 else list(prime_words))
        for w in words:
            tok._register_words(w)
        return tok

    # -- synthetic-vocab word registry -------------------------------------
    def _register_words(self, text: str) -> None:
        """Register every word of ``text`` as a whole token (best effort)."""
        text = _whitespace_clean(_basic_clean(text)).lower()
        for w in find_tokens(text):
            wtok = ("".join(self.byte_encoder[b] for b in w.encode("utf-8"))
                    + "</w>")
            self._word_id(wtok)

    def _word_id(self, wtok: str) -> int | None:
        """Id of a byte-encoded word token ``…</w>`` under the synthetic
        vocab, registering it into the filler space if new.  Slot choice is
        sha1-deterministic (linear probing on collision) so the same word
        gets the same id in every process.  Returns None when the filler
        space is exhausted (caller falls back to per-char tokens)."""
        cached = self.encoder.get(wtok)
        if cached is not None:
            return cached
        if self._n_filler <= 0:
            return None
        import hashlib
        h = int.from_bytes(hashlib.sha1(wtok.encode("utf-8")).digest()[:8],
                           "big")
        for step in range(self._n_filler):
            slot = (h + step) % self._n_filler
            owner = self._filler_owner.get(slot)
            if owner is None:
                self._filler_owner[slot] = wtok
                tid = self._filler_base + slot
                self.encoder[wtok] = tid
                self.decoder[tid] = wtok
                return tid
            if owner == wtok:   # pragma: no cover — encoder hit above
                return self._filler_base + slot
        return None

    # -- BPE core ---------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
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
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    # -- public API -------------------------------------------------------
    def tokenize(self, text: str) -> List[int]:
        """Text -> BPE token ids (no specials, no padding)."""
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for tok in find_tokens(text):
            tok_bytes = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            if self.is_synthetic:
                wid = self._word_id(tok_bytes + "</w>")
                if wid is not None:
                    ids.append(wid)
                    continue   # whole-word token (single-token contract)
            for sub in self._bpe(tok_bytes):
                ids.append(self.encoder[sub])
        return ids

    def __call__(self, texts, max_length: int | None = None) -> np.ndarray:
        """Batch-encode to a fixed (B, 77) int32 array: SOT ids EOT, EOT-padded.

        Matches the reference call contract.
        """
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        out = np.full((len(texts), L), self.eot_id, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = self.tokenize(text)[: L - 2]
            out[i, 0] = self.sot_id
            out[i, 1: 1 + len(ids)] = ids
            # positions 1+len(ids) .. end remain EOT (first one is the true EOT)
        return out

    def decode(self, ids: Iterable[int], skip_specials: bool = True) -> str:
        parts = []
        for i in ids:
            tok = self.decoder[int(i)]
            if skip_specials and tok in (SOT, EOT):
                continue
            parts.append(tok)
        text = "".join(parts)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    @property
    def vocab_size(self) -> int:
        # synthetic word registration aliases filler ids with word strings in
        # the encoder dict; the embedding-table size is the declared layout
        return self._declared_size if self.is_synthetic else len(self.encoder)


# Canonical placeholder pseudo-words (same set as data.face_id's
# PLACEHOLDER_STRINGS / reference aigc_id.yaml placeholder list) — primed
# into every synthetic vocab so they are single tokens with stable ids.
PLACEHOLDER_WORDS: Tuple[str, ...] = ("sks", "ks", "ata", "tre", "ry",
                                      "bop", "rn", "&", "*", "`")


@lru_cache()
def _canonical_prime_words() -> Tuple[str, ...]:
    """Deterministic word list pre-registered into synthetic vocabs.

    Placeholders first (must always win a slot), then every word of the
    shipped celeb-name files — so the offline basis construction and both CLIs
    see identical token ids.  Sorted file order keeps it stable.
    """
    words: List[str] = list(PLACEHOLDER_WORDS)
    root = os.path.normpath(os.path.join(os.path.dirname(__file__),
                                         "..", "..", "infer_images"))
    for fname in ("wiki_names_v2.txt", "celebs.txt", "names.txt"):
        path = os.path.join(root, fname)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                words.extend(sorted({w for line in f
                                     for w in line.strip().lower().split()}))
    return tuple(words)


def token_for_string(tokenizer: CLIPTokenizer, s: str) -> int:
    """The single BPE token id of a placeholder word.

    The reference's ``get_clip_token_for_string`` asserts the word maps to
    exactly one token (embedding_manager.py:13-21); a multi-token placeholder
    would make injection match a *sub*-token anywhere it appears (e.g. the
    's' inside 'person'), silently corrupting conditioning.  The synthetic
    vocab registers whole words as single tokens, so it satisfies the same
    contract; a violation (filler space exhausted) raises just like a
    multi-token word under the real vocab.
    """
    ids = tokenizer.tokenize(s)
    if len(ids) != 1:
        raise ValueError(
            f"placeholder string {s!r} maps to {len(ids)} tokens; "
            f"placeholders must be single-token words "
            f"(reference get_clip_token_for_string contract)")
    return ids[0]


def default_tokenizer(vocab_path: str | None = None) -> CLIPTokenizer:
    """Best-effort tokenizer: real vocab if available, else synthetic.

    Search order: explicit path, $CELEBBASIS_CLIP_VOCAB, ./weights/clip-tokenizer.
    """
    candidates = [vocab_path, os.environ.get("CELEBBASIS_CLIP_VOCAB"),
                  "./weights/clip-tokenizer"]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return CLIPTokenizer.load(cand)
    return CLIPTokenizer.synthetic()
