"""Offline volume tools: `fix` (rebuild a .idx from its .dat) and
`compact`, `export` and `backup` (`volume_tools.py`), and
`filer.remote.sync` (`filer_sync.run_filer_remote_sync`, the write-back of
a remote mount), each a `run*(args)` entry point taking the reference
CLI's flags. The port's copy of those modules of `seaweedfs_tpu/command/`;
the dispatcher (`main.py`) and the server verbs are not ported (ROADMAP
10d-4), nor `filer.sync`, `filer.replicate` and `filer.backup` (10d-3b)."""
