"""seaweedfs_tpu_torch: the PyTorch/CUDA port of seaweedfs_tpu for NVIDIA Hopper.

Its modules mirror `seaweedfs_tpu/` by name. It imports neither JAX nor
anything of `seaweedfs_tpu`: the framework-free modules it needs are kept
here as its own copies. Every entry point runs on `cuda` unless the caller
passes `device="cpu"`; with no device given and no CUDA present it raises.
"""
