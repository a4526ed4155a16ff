"""Parallelism over ``torch.distributed``: tensor-parallel serving
(``serve_sharding``), the logical-axis sharding rules on DTensor
(``sharding``), the sharded train step (``spmd``), the collectives, the
GPipe schedule (``pipeline``), the activation constraint
(``act_sharding``), the loss's global statistics (``global_stats``) and
spawned ranks (``ranks``)."""
