"""Tensor-parallel serving over ``torch.distributed`` (counterpart of
``repro/parallel/serve_sharding.py``)."""
