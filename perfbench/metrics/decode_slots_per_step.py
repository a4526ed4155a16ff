"""Mean decode slots a decode step served in the window: the scheduler's decode_slot_steps over its decode_steps."""
from pbench import layers


def read(records):
    return layers.ratio(records, "decode_slot_steps", "decode_steps")
