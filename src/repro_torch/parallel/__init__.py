"""Device placement of the sharded engine's shards."""
