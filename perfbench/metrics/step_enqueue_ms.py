"""Mean host time a window's step spends in the model's step calls until
they return: the *_enqueue phases of each step record's host_ms."""
from pbench import phases


def read(records):
    return phases.mean_ms(records, phases.ENQUEUE)
