from rowbowt_tpu_torch.parallel.mesh import make_mesh, replicate_index, shard_queries

__all__ = ["make_mesh", "shard_queries", "replicate_index"]
