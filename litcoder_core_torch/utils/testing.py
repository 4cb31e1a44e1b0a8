"""Offline test doubles (twin of litcoder_core_tpu/utils/testing.py).

The tests, examples and chip_smoke.py drive the language-model path with
randomly initialised models and this stub tokenizer instead of downloaded
checkpoints.
"""

import hashlib


class HashStubTokenizer:
    """Deterministic whitespace tokenizer: stable ids via md5(word).

    Implements exactly the tokenizer surface the LM extractor touches
    (encode + the three special-token ids). Ids come from a stable digest,
    not Python's salted str hash(), so the ids, and with them disk-cached
    features, are those of the JAX package's HashStubTokenizer in every
    process regardless of PYTHONHASHSEED.
    """

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0

    def encode(self, text):
        return [
            3 + int(hashlib.md5(w.encode()).hexdigest(), 16) % 500
            for w in text.split()
        ]
