"""moe_load_max.train_dsv2: the most rows any routed expert got in an MoE
call (the `litcoder.lm.moe` span's max_expert_tokens) over the mean per
expert (its tokens x num_experts_per_tok / n_routed_experts), averaged
over the traced MoE calls: 1 is a perfectly even load, and the grouped
GEMMs wait on the busiest expert."""

from cardbench.metrics._spans import record


def read(reading):
    if not reading.traced_jobs:
        return None
    c = reading.cell.config
    spans = [s for s in record() if s["name"] == "litcoder.lm.moe"
             and "max_expert_tokens" in s["counts"]]
    if not spans:
        return None
    share = c["num_experts_per_tok"] / c["n_routed_experts"]
    loads = [s["counts"]["max_expert_tokens"]
             / (s["counts"]["tokens"] * share) for s in spans]
    return sum(loads) / len(loads)
