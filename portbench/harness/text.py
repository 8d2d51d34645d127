"""Descriptions and the T5 ids that stand in for the T5 vocabulary.

The T5 SentencePiece vocabulary is not in the repository.  A word's ids come
from a salted hash of the word: one or two ids in ``[2, vocab)`` (0 pads,
1 ends a text, as in T5's vocabulary), so a description's length follows its
word count.  :class:`WordHashT5` answers as the HF tokenizer does: the ids
of each text, the end id appended, padded with 0 to the longest text of the
call, and the attention mask.  The same word always gets the same ids.

Descriptions draw their words from ``traffic/words.txt``.
"""

from __future__ import annotations

import hashlib
import typing as tp
from pathlib import Path

import numpy as np

WORDS_FILE = Path(__file__).resolve().parent.parent / 'traffic' / 'words.txt'
SALT = b'portbench-t5-ids'


def word_ids(word: str, vocab: int = 32100) -> tp.List[int]:
    digest = hashlib.sha256(SALT + word.encode()).digest()
    n = 1 + digest[0] % 2
    return [2 + int.from_bytes(digest[1 + 4 * i:5 + 4 * i], 'little') % (vocab - 2)
            for i in range(n)]


def text_ids(text: str, vocab: int = 32100) -> tp.List[int]:
    return [i for word in text.split() for i in word_ids(word, vocab)] + [1]


class WordHashT5:
    """A stand-in for the HF T5 tokenizer's call."""

    def __init__(self, vocab: int = 32100):
        self.vocab = vocab

    def __call__(self, entries: tp.Sequence[str], return_tensors: str = 'np',
                 padding: bool = True) -> tp.Dict[str, np.ndarray]:
        rows = [text_ids(e, self.vocab) for e in entries]
        width = max(len(r) for r in rows)
        ids = np.zeros((len(rows), width), dtype=np.int64)
        mask = np.zeros((len(rows), width), dtype=np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return {'input_ids': ids, 'attention_mask': mask}


def words() -> tp.List[str]:
    return [w for w in WORDS_FILE.read_text().split() if w]


def description(rng: np.random.Generator, n_words: int, vocabulary: tp.Sequence[str]) -> str:
    return ' '.join(vocabulary[i] for i in rng.integers(0, len(vocabulary), n_words))


def word_counts(n: int, lo: int, hi: int, rng: np.random.Generator) -> tp.List[int]:
    """``n`` word counts spread evenly over ``[lo, hi]``, in an order drawn
    from ``rng``: every seed gets the same set of lengths."""
    counts = np.round(np.linspace(lo, hi, n)).astype(int) if n > 1 else np.array([lo])
    return [int(c) for c in rng.permutation(counts)]
