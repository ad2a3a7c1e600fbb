"""The sharded tier (counterpart of tpu_knn/distributed/): a mesh of devices,
the reductions over its axes, and v8's reference-set sharding."""
