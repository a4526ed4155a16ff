"""The benchmark's harness: cells, traffic, weights, the reference, the
stamps, the profile and the per-layer arithmetic."""
