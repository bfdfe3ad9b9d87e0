"""Multi-device helpers of the port: the sharding rules as DTensor
placements (``sharding``) and gradient compression (``compression``)."""
