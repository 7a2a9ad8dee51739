"""BERT WordPiece tokenizer (uncased), implemented from scratch.

The port's own copy of ``celebbasis_tpu/text/bert_tokenizer.py`` (pure
Python and numpy; the port imports nothing of the JAX package).  The
reference's BERT text path uses HuggingFace's
``BertTokenizerFast.from_pretrained("bert-base-uncased")`` with
``max_length=77, truncation=True, padding="max_length"``, i.e.
``[CLS] tokens [SEP] [PAD]...``; this module does the same:

* lowercasing, accent stripping and punctuation splitting (BasicTokenizer);
* greedy longest-match WordPiece with ``##`` continuation pieces;
* bert-base-uncased special ids: [PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102.

Without a ``vocab.txt`` (offline), a synthetic whole-word vocab keeps the
textual-inversion single-token placeholder contract (CLS + 1 token + SEP):
every word is registered as ONE deterministic token in the filler space
(sha1 slot and linear probing), as ``text.tokenizer.SyntheticVocab`` does
for CLIP.  The ids are the JAX tokenizer's, bit for bit.
"""
from __future__ import annotations

import hashlib
import os
import unicodedata
from typing import Dict, Iterable, List

import numpy as np

PAD_ID, UNK_ID, CLS_ID, SEP_ID = 0, 100, 101, 102
_SPECIALS = {"[PAD]": PAD_ID, "[UNK]": UNK_ID, "[CLS]": CLS_ID,
             "[SEP]": SEP_ID, "[MASK]": 103}
BERT_VOCAB_SIZE = 30522


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str) -> List[str]:
    """BasicTokenizer(do_lower_case=True): lowercase, strip accents, split
    on whitespace, and split punctuation into standalone tokens."""
    text = unicodedata.normalize("NFD", text.lower())
    text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    out: List[str] = []
    for word in text.split():
        buf = ""
        for ch in word:
            if _is_punct(ch):
                if buf:
                    out.append(buf)
                    buf = ""
                out.append(ch)
            else:
                buf += ch
        if buf:
            out.append(buf)
    return out


class BERTTokenizer:
    """WordPiece tokenizer with the reference's (B, 77) CLS/SEP/PAD contract."""

    def __init__(self, vocab: Dict[str, int], max_length: int = 77):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.max_length = max_length
        self.is_synthetic = False
        self._filler_owner: Dict[int, str] = {}
        self._filler_base = 0
        self._n_filler = 0
        self._declared_size = len(self.encoder)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str, max_length: int = 77
                        ) -> "BERTTokenizer":
        with open(path, encoding="utf-8") as f:
            vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        return cls(vocab, max_length)

    @classmethod
    def synthetic(cls, size: int = BERT_VOCAB_SIZE, max_length: int = 77
                  ) -> "BERTTokenizer":
        """Offline whole-word vocab: specials at the standard bert ids, the
        rest of the id space a deterministic word registry (sha1 slot +
        linear probing, like the CLIP SyntheticVocab)."""
        tok = cls(dict(_SPECIALS), max_length)
        tok.is_synthetic = True
        tok._filler_base = 104
        tok._n_filler = size - 104
        tok._declared_size = size
        return tok

    # -- synthetic registry ---------------------------------------------------
    def _word_id(self, word: str) -> int:
        cached = self.encoder.get(word)
        if cached is not None:
            return cached
        h = int.from_bytes(hashlib.sha1(word.encode("utf-8")).digest()[:8],
                           "big")
        for step in range(self._n_filler):
            slot = (h + step) % self._n_filler
            owner = self._filler_owner.get(slot)
            if owner is None:
                self._filler_owner[slot] = word
                tid = self._filler_base + slot
                self.encoder[word] = tid
                self.decoder[tid] = word
                return tid
            if owner == word:   # pragma: no cover — encoder hit above
                return self._filler_base + slot
        return UNK_ID

    # -- WordPiece ------------------------------------------------------------
    def _wordpiece(self, word: str) -> List[int]:
        if self.is_synthetic:
            return [self._word_id(word)]
        if len(word) > 100:
            return [UNK_ID]
        pieces: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.encoder:
                    piece_id = self.encoder[sub]
                    break
                end -= 1
            if piece_id is None:
                return [UNK_ID]
            pieces.append(piece_id)
            start = end
        return pieces

    # -- public API -------------------------------------------------------------
    def tokenize(self, text: str) -> List[int]:
        """Text -> WordPiece ids (no specials, no padding)."""
        ids: List[int] = []
        for word in basic_tokenize(text):
            ids.extend(self._wordpiece(word))
        return ids

    def __call__(self, texts, max_length: int | None = None) -> np.ndarray:
        """Batch-encode to (B, L) int32: [CLS] ids [SEP], zero-padded."""
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        out = np.full((len(texts), L), PAD_ID, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = self.tokenize(text)[: L - 2]
            out[i, 0] = CLS_ID
            out[i, 1: 1 + len(ids)] = ids
            out[i, 1 + len(ids)] = SEP_ID
        return out

    def decode(self, ids: Iterable[int]) -> str:
        words = [self.decoder.get(int(i), "[UNK]") for i in ids
                 if int(i) not in (PAD_ID, CLS_ID, SEP_ID)]
        text = " ".join(words).replace(" ##", "")
        return text.strip()

    @property
    def vocab_size(self) -> int:
        return self._declared_size


def default_bert_tokenizer(vocab_path: str | None = None) -> BERTTokenizer:
    """Real vocab.txt if available, else the synthetic whole-word vocab.

    Search order: explicit path, $CELEBBASIS_BERT_VOCAB,
    ./weights/bert-tokenizer/vocab.txt.
    """
    candidates = [vocab_path, os.environ.get("CELEBBASIS_BERT_VOCAB"),
                  "./weights/bert-tokenizer/vocab.txt"]
    for cand in candidates:
        if cand and os.path.exists(cand):
            if os.path.isdir(cand):
                cand = os.path.join(cand, "vocab.txt")
            return BERTTokenizer.from_vocab_file(cand)
    return BERTTokenizer.synthetic()
