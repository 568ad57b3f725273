"""Distribution levers of the port: ``logical`` (logical axis names, the
mesh context, ``shard``, per-shard kernel calls), ``sharding`` (the
reference's rule tables as DTensor placements) and ``precision``
(``bf16_cotangent``)."""
