"""TextSet and GloVe loading: the port's copy.

A copy of ``analytics_zoo_tpu/data/text.py`` (numpy and the standard
library; pandas is imported inside ``read_csv`` only), pinned to it by
``tests/test_torch_serving_pins.py``, on the port's ``data/shards.py``
and ``common/fs.py``.  ``TextSet.from_texts(...).tokenize().word2idx()
.shape_sequence(length)`` gives ``to_numpy_dict()``'s ``{"tokens": int32
[N, length], "y": int32 [N]}``, which the text estimators
(``tfpark.text``) and the Estimator take.  Ids: 0 pads, 1 is out of
vocabulary, 2 and up rank the words by count (``Counter.most_common``'s
order on ties); ``shape_sequence`` truncates at the front (``"pre"``)
or the back (``"post"``) and pads after the text; ``vocab_size`` is
the highest id plus one (an ``existing_index`` may be sparse).
``load_glove(path, word_index, embed_dim)`` returns the table and its
hits: rows drawn from ``default_rng(0)``, a zero pad row, the file's
vectors where a word is indexed, malformed lines skipped.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.data.shards import XShards

_TOKEN_RE = re.compile(r"[^\W_]+(?:'[^\W_]+)?", re.UNICODE)


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text)


def normalize(tokens: List[str]) -> List[str]:
    return [t.lower() for t in tokens]


class TextFeature:
    """One sample: raw text (+ optional label) and derived fields."""

    def __init__(self, text: str, label: Optional[int] = None):
        self.text = text
        self.label = label
        self.tokens: Optional[List[str]] = None
        self.indices: Optional[np.ndarray] = None


class TextSet:
    """ref-parity stages, eager per-shard application."""

    PAD_ID = 0
    OOV_ID = 1
    FIRST_WORD_ID = 2

    def __init__(self, shards: XShards,
                 word_index: Optional[Dict[str, int]] = None):
        self.shards = shards
        self.word_index = word_index

    # ---- constructors -------------------------------------------------

    @staticmethod
    def from_texts(texts: Sequence[str],
                   labels: Optional[Sequence[int]] = None,
                   num_shards: int = 1) -> "TextSet":
        labels = labels if labels is not None else [None] * len(texts)
        feats = [TextFeature(t, l) for t, l in zip(texts, labels)]
        return TextSet(XShards.from_list(feats, num_shards))

    @staticmethod
    def read_csv(path: str, text_col: str = "text",
                 label_col: Optional[str] = "label",
                 num_shards: int = 1) -> "TextSet":
        import pandas as pd

        df = pd.read_csv(path)
        labels = df[label_col].tolist() if label_col and label_col in df \
            else None
        return TextSet.from_texts(df[text_col].tolist(), labels, num_shards)

    # ---- stages -------------------------------------------------------

    def tokenize(self) -> "TextSet":
        def fn(feats):
            for f in feats:
                f.tokens = normalize(tokenize(f.text))
            return feats
        return TextSet(self.shards.transform_shard(fn), self.word_index)

    def word2idx(self, remove_topn: int = 0,
                 max_words_num: Optional[int] = None,
                 existing_index: Optional[Dict[str, int]] = None
                 ) -> "TextSet":
        """Build (or adopt) the word index and map tokens to ids.
        ids: 0=pad, 1=oov, 2.. = vocabulary by frequency rank."""
        if existing_index is not None:
            index = dict(existing_index)
        else:
            counts: Counter = Counter()
            for feats in self.shards.collect():
                for f in feats:
                    if f.tokens is None:
                        raise RuntimeError("call tokenize() before word2idx")
                    counts.update(f.tokens)
            ranked = [w for w, _ in counts.most_common()]
            ranked = ranked[remove_topn:]
            if max_words_num is not None:
                ranked = ranked[:max_words_num]
            index = {w: i + TextSet.FIRST_WORD_ID
                     for i, w in enumerate(ranked)}

        def fn(feats):
            for f in feats:
                f.indices = np.asarray(
                    [index.get(t, TextSet.OOV_ID) for t in f.tokens],
                    np.int32)
            return feats
        return TextSet(self.shards.transform_shard(fn), index)

    def shape_sequence(self, length: int,
                       trunc_mode: str = "pre") -> "TextSet":
        """Pad (post) / truncate (pre|post) to fixed `length`."""
        def fn(feats):
            for f in feats:
                idx = f.indices
                if len(idx) > length:
                    idx = idx[-length:] if trunc_mode == "pre" \
                        else idx[:length]
                elif len(idx) < length:
                    idx = np.concatenate(
                        [idx, np.zeros(length - len(idx), np.int32)])
                f.indices = idx
            return feats
        return TextSet(self.shards.transform_shard(fn), self.word_index)

    # ---- outputs ------------------------------------------------------

    def to_numpy_dict(self) -> Dict[str, np.ndarray]:
        toks, labels = [], []
        for feats in self.shards.collect():
            for f in feats:
                if f.indices is None:
                    raise RuntimeError(
                        "run tokenize/word2idx/shape_sequence first")
                toks.append(f.indices)
                labels.append(-1 if f.label is None else int(f.label))
        return {"tokens": np.stack(toks),
                "y": np.asarray(labels, np.int32)}

    def vocab_size(self) -> int:
        """Embedding-table rows needed: covers pad, oov and the HIGHEST
        word id (a user-supplied existing_index may be sparse, so counting
        entries would under-size the table and silently clamp gathers)."""
        if self.word_index is None:
            raise RuntimeError("word2idx not run")
        top = max(self.word_index.values(),
                  default=TextSet.FIRST_WORD_ID - 1)
        return max(top + 1, TextSet.FIRST_WORD_ID)


def load_glove(path: str, word_index: Dict[str, int],
               embed_dim: int) -> Tuple[np.ndarray, int]:
    """GloVe txt → embedding matrix aligned to `word_index`
    (ref: WordEmbedding loading). Rows 0 (pad) and 1 (oov) are zero /
    mean-init; OOV words get small random vectors. Returns (weights,
    n_hits)."""
    # size by the max id, not len(): a user-supplied index may be sparse
    vocab_rows = max(max(word_index.values(),
                         default=TextSet.FIRST_WORD_ID - 1) + 1,
                     TextSet.FIRST_WORD_ID)
    rng = np.random.default_rng(0)
    weights = rng.normal(0, 0.1, (vocab_rows, embed_dim)).astype(np.float32)
    weights[TextSet.PAD_ID] = 0.0
    hits = 0
    import io

    from analytics_zoo_tpu_torch.common import fs

    with fs.open(path, "rb") as raw, \
            io.TextIOWrapper(raw, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != embed_dim + 1:
                continue
            idx = word_index.get(parts[0])
            if idx is not None:
                weights[idx] = np.asarray(parts[1:], np.float32)
                hits += 1
    return weights, hits
