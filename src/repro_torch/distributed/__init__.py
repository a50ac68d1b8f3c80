"""Distribution layer of the port: the serving tensor-parallel plan and the
backbone's shard rules (``sharding``), and the all-reduce hooks the model
calls (``collectives``)."""
