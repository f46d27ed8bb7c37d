"""The port's `weed-tpu` CLI: `main.py` dispatches every verb of the JAX
package's `seaweedfs_tpu/command/main.py` to the port's own module — the
server verbs (`server_cmds.py`), `benchmark`, `upload`/`download`,
`scaffold`, `version`, the offline volume tools (`fix.py`,
`volume_tools.py`), the `filer.*` verbs (`filer_sync.py`) and `shell`.
Each module exposes `run*(args) -> int` taking the reference CLI's flags."""
