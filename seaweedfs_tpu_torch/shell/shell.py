"""Interactive admin shell REPL (reference `weed/shell/shell_liner.go:27`).

The port's copy of `seaweedfs_tpu/shell/shell.py`, without `-filer` (no
ported command reads a filer). Run it as
`python -m seaweedfs_tpu_torch.shell.shell -master <host:port> [cmd...]`,
or feed it commands on standard input."""

from __future__ import annotations

import sys

from .env import CommandEnv, ShellError
from .registry import run_command


def run(args: list[str]) -> int:
    """CLI entry: shell [-master url] [cmd...]"""
    master = "http://127.0.0.1:9333"
    rest: list[str] = []
    i = 0
    while i < len(args):
        if args[i] == "-master" and i + 1 < len(args):
            master = args[i + 1]
            i += 2
        else:
            rest.append(args[i])
            i += 1
    if not master.startswith("http"):
        master = f"http://{master}"
    script = " ".join(rest) if rest else (None if sys.stdin.isatty() else sys.stdin.read())
    return run_shell(master, script)


def run_shell(
    master_url: str,
    script: str | None = None,
    out=sys.stdout,
) -> int:
    """REPL over stdin, or execute `script` (semicolon/newline-separated)
    non-interactively, like `echo "volume.list" | weed shell`."""
    env = CommandEnv(master_url)
    rc = 0

    def run_line(line: str) -> None:
        nonlocal rc
        line = line.strip()
        if not line or line.startswith("#"):
            return
        try:
            result = run_command(env, line)
            if result:
                print(result, file=out)
        except ShellError as e:
            print(f"error: {e}", file=out)
            rc = 1
        except Exception as e:
            print(f"error: {e}", file=out)
            rc = 1

    try:
        if script is not None:
            for line in script.replace(";", "\n").splitlines():
                run_line(line)
        else:
            print("seaweedfs-tpu shell — `help` lists commands, ctrl-d exits",
                  file=out)
            while True:
                try:
                    line = input("> ")
                except EOFError:
                    break
                if line.strip() in ("exit", "quit"):
                    break
                run_line(line)
    finally:
        if env.locked:
            try:
                env.release_lock()
            except Exception:
                pass
    return rc


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
