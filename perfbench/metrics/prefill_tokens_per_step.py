"""Mean prompt tokens a prefill step served in the window: the scheduler's prefill_chunk_tokens over its prefill_steps."""
from pbench import layers


def read(records):
    return layers.ratio(records, "prefill_chunk_tokens", "prefill_steps")
