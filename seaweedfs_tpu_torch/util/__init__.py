"""Host utilities of the port: its copies of `seaweedfs_tpu/util/` modules."""
