"""Static token embeddings (twin of
litcoder_core_tpu/features/embeddings.py).

The JAX package's self-contained loaders, gensim-free: .kv bundles (.npz
files with 'vectors' (V, D) float32 and 'vocab' (V,) strings; the port reads
and writes the same files as the JAX package), word2vec binary and text,
and GloVe's header-less text, gzipped or not.
"""

import gzip
import os
import re
from typing import Any, Dict, List, Optional, Union

import numpy as np

from litcoder_core_torch.features.base import BaseFeatureExtractor


class SimpleKeyedVectors:
    """Minimal KeyedVectors: vocab dict + (V, D) matrix."""

    def __init__(self, vocab: List[str], vectors: np.ndarray):
        self.index_to_key = list(vocab)
        self.key_to_index = {w: i for i, w in enumerate(self.index_to_key)}
        self.vectors = np.asarray(vectors, np.float32)
        self.vector_size = int(self.vectors.shape[1])

    def get_vector(self, key: str) -> np.ndarray:
        return self.vectors[self.key_to_index[key]]

    def __contains__(self, key: str) -> bool:
        return key in self.key_to_index

    def save_kv(self, path: str) -> None:
        if not path.endswith(".kv"):
            path = path + ".kv"
        # Through a handle, so numpy keeps the .kv name (np.savez appends
        # .npz to a bare string path).
        with open(path, "wb") as f:
            np.savez(f, vectors=self.vectors,
                     vocab=np.array(self.index_to_key, dtype=object))

    @classmethod
    def load_kv(cls, path: str) -> "SimpleKeyedVectors":
        # The vocab is an object array, so this unpickles: load only
        # bundles written by save_kv of this package or the JAX package.
        data = np.load(path, allow_pickle=True)
        return cls([str(w) for w in data["vocab"]], data["vectors"])

    # ---- word2vec / GloVe readers ------------------------------------------

    @classmethod
    def load_word2vec_format(cls, path: str, binary: bool = False,
                             no_header: bool = False) -> "SimpleKeyedVectors":
        opener = gzip.open if path.endswith(".gz") else open
        if binary:
            with opener(path, "rb") as f:
                header = f.readline().split()
                vocab_size, dim = int(header[0]), int(header[1])
                vocab, vecs = [], np.empty((vocab_size, dim), np.float32)
                width = 4 * dim
                for i in range(vocab_size):
                    word = bytearray()
                    while True:
                        ch = f.read(1)
                        if ch == b"":
                            raise ValueError(
                                f"truncated word2vec binary file: header "
                                f"declares {vocab_size} vectors but EOF hit "
                                f"at vector {i}"
                            )
                        if ch == b" ":
                            break
                        if ch != b"\n":
                            word.extend(ch)
                    vocab.append(word.decode("utf-8", errors="replace"))
                    vecs[i] = np.frombuffer(f.read(width), np.float32)
            return cls(vocab, vecs)

        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            first = f.readline().rstrip("\n")
            parts = first.split(" ")
            vocab, rows = [], []
            if not no_header and len(parts) == 2:
                pass  # header consumed
            else:
                vocab.append(parts[0])
                rows.append(np.array(parts[1:], np.float32))
            for line in f:
                parts = line.rstrip("\n").split(" ")
                vocab.append(parts[0])
                rows.append(np.array(parts[1:], np.float32))
        return cls(vocab, np.stack(rows))


class StaticEmbeddingFeatureExtractor(BaseFeatureExtractor):
    """Token -> static vector lookup with OOV policies.

    Config keys: vector_path (required: a .kv bundle, or word2vec/GloVe
    vectors), lowercase, oov_handling (copy_prev|zero|skip|error), binary,
    no_header (both inferred from the file name when absent),
    l2_normalize_tokens, tokenizer_pattern."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        vector_path = config.get("vector_path", "")
        if not vector_path:
            raise ValueError("'vector_path' is required.")
        self.vector_path = os.path.abspath(os.path.expanduser(vector_path))
        if not os.path.exists(self.vector_path):
            raise FileNotFoundError(
                f"Vector file not found: {self.vector_path}")
        self.lowercase = bool(config.get("lowercase", True))
        self.oov_handling = config.get("oov_handling", "copy_prev")
        if self.oov_handling not in {"copy_prev", "zero", "skip", "error"}:
            raise ValueError(
                "oov_handling must be 'copy_prev', 'zero', 'skip', or 'error'"
            )
        self.l2_normalize_tokens = bool(config.get("l2_normalize_tokens",
                                                   False))
        self.tokenizer_pattern = config.get("tokenizer_pattern",
                                            r"[A-Za-z0-9_']+")
        self._force_binary: Optional[bool] = config.get("binary", None)
        self._force_no_header: Optional[bool] = config.get("no_header", None)
        self._tok_re = re.compile(self.tokenizer_pattern)
        self.kv = self._load_local_vectors(self.vector_path)
        self.dim = self.kv.vector_size

    def extract_features(self, stimuli: Union[str, List[str]],
                         **kwargs) -> np.ndarray:
        """Tokens -> (N, D); a string is tokenized first."""
        if isinstance(stimuli, str):
            text = stimuli.lower() if self.lowercase else stimuli
            tokens: List[Any] = self._tok_re.findall(text)
        elif isinstance(stimuli, list):
            tokens = [
                (t.lower() if self.lowercase else t) if isinstance(t, str)
                else t
                for t in stimuli
            ]
        else:
            raise TypeError(
                "extract_features expects a List[str] of tokens or a string."
            )
        if not tokens:
            return np.zeros((0, self.dim), np.float32)

        idx = np.array(
            [self.kv.key_to_index.get(t, -1) if isinstance(t, str) else -1
             for t in tokens],
            np.int64,
        )
        valid = idx >= 0
        if self.oov_handling == "error" and not valid.all():
            bad = int(np.nonzero(~valid)[0][0])
            raise KeyError(f"OOV token at index {bad}: {tokens[bad]!r}")
        if self.oov_handling == "skip":
            idx, valid = idx[valid], valid[valid]

        out = self.kv.vectors[np.clip(idx, 0, None)].copy()
        if self.oov_handling in ("zero", "skip"):
            out[~valid] = 0.0
        elif self.oov_handling == "copy_prev":
            # Forward-fill from the previous valid row; zeros before the first.
            pos = np.arange(len(idx))
            last_valid = np.maximum.accumulate(np.where(valid, pos, -1))
            src = np.where(last_valid >= 0, last_valid, 0)
            out = np.where(
                valid[:, None], out,
                np.where((last_valid >= 0)[:, None], out[src], 0.0),
            )

        if self.l2_normalize_tokens:
            norms = np.linalg.norm(out, axis=1, keepdims=True)
            out = np.where(norms > 0, out / np.where(norms == 0, 1, norms),
                           out)
        return out.astype(np.float32)

    # ---- loading -------------------------------------------------------------

    def _load_local_vectors(self, path: str) -> SimpleKeyedVectors:
        ext = path.lower()
        if ext.endswith(".kv") or ext.endswith(".kv.npz"):
            return SimpleKeyedVectors.load_kv(path)
        binary = (self._infer_binary(ext) if self._force_binary is None
                  else bool(self._force_binary))
        no_header = (self._infer_no_header(ext) if self._force_no_header is None
                     else bool(self._force_no_header))
        try:
            return SimpleKeyedVectors.load_word2vec_format(
                path, binary=binary, no_header=no_header
            )
        except Exception as e:
            if ext.endswith(".txt") or ext.endswith(".txt.gz"):
                try:
                    return SimpleKeyedVectors.load_word2vec_format(
                        path, binary=False, no_header=not no_header
                    )
                except Exception as e2:
                    raise RuntimeError(
                        f"Failed to load vectors from {path}: {e} / {e2}"
                    ) from e2
            raise

    @staticmethod
    def _infer_binary(ext: str) -> bool:
        return ext.endswith(".bin") or ext.endswith(".bin.gz")

    @staticmethod
    def _infer_no_header(ext: str) -> bool:
        if ext.endswith(".w2v.txt"):
            return False
        return ext.endswith(".txt") or ext.endswith(".txt.gz")
