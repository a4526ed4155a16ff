"""Share of the rows the prefill call computed that carried a prompt token in the window: the scheduler's prefill_chunk_tokens over its prefill_computed_tokens."""
from pbench import layers


def read(records):
    return layers.ratio(records, "prefill_chunk_tokens", "prefill_computed_tokens")
