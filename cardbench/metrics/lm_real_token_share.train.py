"""lm_real_token_share.train: real tokens over the padded tokens the LM
forwards ran (the extractor's `counts`), in percent: useful work over
attempted."""


def read(reading):
    real = sum(r["program"]["counts"]["real_tokens"] for r in reading.records)
    padded = sum(r["program"]["counts"]["padded_tokens"]
                 for r in reading.records)
    return 100.0 * real / padded if padded else None
