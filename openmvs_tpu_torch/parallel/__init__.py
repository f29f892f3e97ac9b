"""Multi-device paths: a (views, tile) grid of shards held by one process
(``mesh.ShardMesh``) with explicit collectives between the shards, the
sharded dense estimation, SGM pairs and fusion reduction (``sharded``), and
the sharded cross-view filter (``sharded_filter``). Counterpart of the JAX
package's ``openmvs_tpu/parallel/``."""
