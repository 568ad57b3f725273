"""Distribution levers of the port.  Only ``precision.bf16_cotangent`` is
ported; the mesh, logical axes and sharding rules wait for ROADMAP
'Waiting 2' (distribution)."""
