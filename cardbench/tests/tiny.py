"""Tiny versions of the cells for CPU runs: every width cut, every path
the same (the LM cell's tiny design is tall, so its fit takes the
Cholesky search)."""

TINY = {
    "lebel.fit": {
        "config": {"n_train_trs": 400, "n_test_trs": 100, "n_features": 12,
                   "n_voxels": 40},
        "params": {"rank": 4, "n_null": 4, "block": 16}},
    "lebel.fit_chunked_perm": {
        "config": {"n_train_trs": 400, "n_test_trs": 100, "n_features": 12,
                   "n_voxels": 40},
        "params": {"rank": 4, "n_null": 4, "block": 16,
                   "fit": {"voxel_chunk_size": 16}}},
    "narratives.fit": {
        "config": {"n_train_trs": 300, "n_features": 400, "n_voxels": 40},
        "params": {"rank": 4, "n_null": 4, "block": 16}},
    "lebel.train_lm": {
        "config": {"n_embd": 16, "n_layer": 2, "n_head": 2,
                   "n_positions": 64, "vocab_size": 600, "n_voxels": 30,
                   "trs_per_story": 120, "lookback": 16, "n_features": 64,
                   "layer_idx": 1},
        "params": {"words_per_story": 300, "block": 16, "signal_rank": 4,
                   "route": {"mode": "train_test", "alpha_search": "chol",
                             "fast_scan": "off"}}},
}

SEED = 2 ** 31 + 12345
