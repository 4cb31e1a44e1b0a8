"""Segment (word -> TR) pooling on tensors (twin of
litcoder_core_tpu/ops/segment.py).

Two split-index conventions of the reference:
- per-word TR ids ('average'/'sum'/'last'): segment_ids[i] = TR of word i;
- np.split boundary positions ('legacy_*'), turned into per-row ids by
  boundaries_to_segment_ids.
Empty segments and empty rect windows give zero rows. On CUDA index_add_
sums in atomic order, so sums and means agree with the CPU to rounding,
not bit for bit.
"""

import torch


def segment_sum_pool(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Sum of the rows of `data` per segment id."""
    data = data.to(torch.float32)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=torch.float32, device=data.device)
    return out.index_add_(0, segment_ids.to(data.device, torch.long), data)


def segment_mean_pool(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Mean of the rows of `data` per segment id."""
    ids = segment_ids.to(data.device, torch.long)
    counts = torch.bincount(ids, minlength=num_segments).to(torch.float32)
    sums = segment_sum_pool(data, ids, num_segments)
    return sums / torch.clamp(counts, min=1.0).reshape(
        (-1,) + (1,) * (sums.ndim - 1))


def segment_last_pool(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """The row with the highest index in each segment."""
    data = data.to(torch.float32)
    ids = segment_ids.to(data.device, torch.long)
    last = torch.full((num_segments,), -1, dtype=torch.long,
                      device=data.device).scatter_reduce_(
        0, ids, torch.arange(data.shape[0], device=data.device), "amax")
    has_any = (last >= 0).reshape((-1,) + (1,) * (data.ndim - 1))
    return torch.where(has_any, data[torch.clamp(last, min=0)], 0.0)


def boundaries_to_segment_ids(n_rows: int,
                              boundaries: torch.Tensor) -> torch.Tensor:
    """Per-row segment ids of np.split(data, boundaries): row i belongs to
    chunk searchsorted(boundaries, i, side='right')."""
    rows = torch.arange(n_rows, device=boundaries.device)
    return torch.searchsorted(boundaries.to(torch.long), rows, right=True)


def rect_pool(data: torch.Tensor, data_times: torch.Tensor,
              tr_times: torch.Tensor) -> torch.Tensor:
    """Box-filter pooling: the mean of the samples in [t - TR/2, t + TR/2)
    around each TR time t, TR = mean(diff(tr_times)) in float32, as one
    masked-mean matmul over (n_tr, n_samples)."""
    data_times = data_times.to(torch.float32)
    tr_times = tr_times.to(torch.float32)
    tr = torch.mean(torch.diff(tr_times))
    lo = tr_times[:, None] - tr / 2.0
    hi = tr_times[:, None] + tr / 2.0
    mask = ((data_times[None, :] >= lo)
            & (data_times[None, :] < hi)).to(torch.float32)
    weights = mask / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    return weights @ data.to(torch.float32)
