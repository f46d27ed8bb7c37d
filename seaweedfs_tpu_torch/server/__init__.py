"""Servers of the port: its copies of `seaweedfs_tpu/server/` modules."""
