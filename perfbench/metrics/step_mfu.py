"""Percent of the traced window the H100 would need, at its data-sheet peaks, for the model's work in the window's steps (int8 sites, the f32 head, attention)."""
from pbench import layers


def read(records):
    return layers.step_mfu(records)
