"""Planted-signal regression problems, drawn on the device from a seed.

A frozen copy of chip_smoke.signal_problem (itself benchmarks/full_cv.py's
and benchmarks/northstar.py's generator) with the width as an argument:
X (T, D) standard normal, Y = X W M + unit noise, W (D, rank) / sqrt(D),
M (rank, V) / sqrt(rank), so each voxel's signal variance is about 1 and
its r ceiling about 0.707. With `uniform_gain` each column of M is then
scaled by its own draw from U(0, 1), so voxels range from pure noise to the
full signal, as over a whole brain most respond weakly. The first `n_null`
columns of M are zeroed: those voxels are pure noise, so the p-values and
BH-FDR see both kinds of voxel. Every seed draws the same sizes.
"""

import torch

from cardbench.precision import tf32


def signal_problem(n_rows: int, n_features: int, n_voxels: int, rank: int,
                   n_null: int, seed: int, device, noise_std: float = 1.0,
                   uniform_gain: bool = False):
    """(X (n_rows, n_features), Y (n_rows, n_voxels)) float32 on `device`,
    in four large draws from one generator seeded with `seed`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    X = torch.randn((n_rows, n_features), device=dev, generator=gen)
    W = torch.randn((n_features, rank), device=dev,
                    generator=gen) / n_features ** 0.5
    M = torch.randn((rank, n_voxels), device=dev, generator=gen) / rank ** 0.5
    if uniform_gain:
        M *= torch.rand(n_voxels, device=dev, generator=gen)
    M[:, :n_null] = 0.0
    # fp32 products whatever the caller's TF32 setting: the problem must not
    # depend on who draws it.
    with tf32(False):
        Y = (X @ W) @ M
    # Noise in blocks of rows, so the draw never holds a second Y.
    for lo in range(0, n_rows, NOISE_BLOCK_ROWS):
        hi = min(lo + NOISE_BLOCK_ROWS, n_rows)
        Y[lo:hi].add_(torch.randn((hi - lo, n_voxels), device=dev,
                                  generator=gen), alpha=noise_std)
    return X, Y


NOISE_BLOCK_ROWS = 4096
