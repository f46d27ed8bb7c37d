"""The port's CLI (`seaweedfs_tpu_torch/command/main.py` and its verbs) held
against the JAX package's: the five cases of `tests/test_commands.py`
(compact, export, backup full then incremental, every scaffold template
parses, `load_configuration`'s search) through each package's dispatcher on
the same inputs, the verb list of `main(["help"])`, every verb's flags
(option strings, destinations, defaults, choices, nargs and types) equal to
the JAX parser's plus `-device` on `volume`, `filer` and `server` only, and
`version` and every `scaffold` output byte-equal. Tolerance 0."""

from __future__ import annotations

import argparse
import os

import pytest

import seaweedfs_tpu.command.main as ref_main
import seaweedfs_tpu.command.scaffold as ref_scaffold
from seaweedfs_tpu_torch.command import main as port_main
from seaweedfs_tpu_torch.command import scaffold
from tests._threads import stop_history_loops  # noqa: F401
from tests.test_torch_shell_volume import base
from tests.test_torch_volume_admin import allocate, delete, pinned_clock, twin, write
from tests.test_torch_volume_tools import both, copies, read  # noqa: F401

DEVICE_VERBS = {"volume", "filer", "server"}


def via(main_mod, verb):
    """A verb as the dispatcher runs it: `main([verb, *args])`."""
    return lambda args: main_mod.main([verb, *args])


def stdout_of(capsys, main_mod, argv) -> str:
    assert main_mod.main(argv) == 0
    return capsys.readouterr().out


# --- the five cases of tests/test_commands.py --------------------------------
def test_compact_cli_equals_reference(copies, capsys):
    lines = both(capsys, via(port_main, "compact"), via(ref_main, "compact"),
                 *[["-dir", d, "-collection", "c", "-volumeId", "5"] for d in copies])
    assert "->" in lines[0]
    for ext in (".dat", ".idx"):
        assert read(os.path.join(copies[0], "c_5" + ext)) == \
            read(os.path.join(copies[1], "c_5" + ext))


def test_export_tar_and_dir_equals_reference(copies, capsys, tmp_path):
    # the fixture's three overwrites carry no last_modified, so each
    # export stamps their tar members with time.time(): one clock for both
    for how in ("tar", "dir"):
        args = []
        for name, d in zip(("port", "ref"), copies):
            a = ["-dir", d, "-collection", "c", "-volumeId", "5"]
            a += (["-o", str(tmp_path / f"{name}.tar")] if how == "tar"
                  else ["-outputDir", str(tmp_path / f"{name}-out")])
            args.append(a)
        with pinned_clock():
            both(capsys, via(port_main, "export"), via(ref_main, "export"), *args)
    assert read(str(tmp_path / "port.tar")) == read(str(tmp_path / "ref.tar"))
    trees = []
    for name in ("port", "ref"):
        root = tmp_path / f"{name}-out"
        trees.append(sorted((str(p.relative_to(root)), p.read_bytes())
                            for p in root.rglob("*") if p.is_file()))
    assert trees[0] == trees[1] and len(trees[0]) == 25


def test_backup_full_then_incremental_equals_reference(tmp_path, capsys):
    import numpy as np

    rng = np.random.default_rng(52)
    first = {nid: rng.bytes(int(rng.integers(1, 4000))) for nid in range(1, 11)}
    more = {nid: rng.bytes(int(rng.integers(1, 4000))) for nid in range(11, 16)}
    with twin(racks=("r1",)) as (ref, port):
        sides = (port, ref)
        with pinned_clock(1_700_000_000):
            for side in sides:
                allocate(side, 3, [0])
                for nid, data in first.items():
                    write(side, 0, 3, nid, data)
        dirs = [str(tmp_path / name) for name in ("port", "ref")]
        args = [["-server", side.url(0).split("//", 1)[1], "-volumeId", "3", "-dir", d]
                for side, d in zip(sides, dirs)]
        lines = both(capsys, via(port_main, "backup"), via(ref_main, "backup"), *args)
        assert lines[-1].startswith("full backup of volume 3 -> ")
        with pinned_clock(1_700_000_100):
            for side in sides:
                for nid, data in more.items():
                    write(side, 0, 3, nid, data)
                delete(side, 0, 3, 2)
        lines = both(capsys, via(port_main, "backup"), via(ref_main, "backup"), *args)
        assert lines[-1].startswith("incremental backup of volume 3: +")
        for ext in (".dat", ".idx"):
            assert read(os.path.join(dirs[0], "3" + ext)) == \
                read(os.path.join(dirs[1], "3" + ext))
        assert read(os.path.join(dirs[0], "3.dat")) == read(base(port, 0, 3) + ".dat")


def test_scaffold_all_templates_parse(tmp_path, capsys):
    import tomllib

    assert scaffold.TEMPLATES == ref_scaffold.TEMPLATES
    for body in scaffold.TEMPLATES.values():
        tomllib.loads(body)
    assert "[jwt.signing]" in stdout_of(capsys, port_main,
                                        ["scaffold", "-config", "security"])
    outs = []
    for main_mod, name in ((port_main, "port"), (ref_main, "ref")):
        d = tmp_path / name
        d.mkdir()
        out = stdout_of(capsys, main_mod,
                        ["scaffold", "-config", "master", "-output", str(d)])
        outs.append(out.replace(str(d), "<dir>"))
    assert outs[0] == outs[1] == "wrote <dir>/master.toml\n"
    assert (tmp_path / "port" / "master.toml").read_bytes() == \
        (tmp_path / "ref" / "master.toml").read_bytes()


def test_load_configuration_search(tmp_path, monkeypatch):
    import seaweedfs_tpu.util.config as ref_cfg
    from seaweedfs_tpu_torch.util import config as cfg

    (tmp_path / "demo.toml").write_text("[top]\nkey = 'v'\n")
    for mod in (cfg, ref_cfg):
        monkeypatch.setattr(mod, "SEARCH_DIRS", [str(tmp_path)])
        assert mod.load_configuration("demo") == {"top": {"key": "v"}}
        assert mod.load_configuration("absent") == {}
        with pytest.raises(FileNotFoundError):
            mod.load_configuration("absent", required=True)


# --- the dispatcher ----------------------------------------------------------
def test_help_lists_the_reference_verbs(capsys):
    port_out = stdout_of(capsys, port_main, ["help"])
    ref_out = stdout_of(capsys, ref_main, ["help"])
    assert port_out == ref_out
    assert sorted(port_main.COMMANDS) == sorted(ref_main.COMMANDS)
    for name, (module, fn, help_line) in port_main.COMMANDS.items():
        ref_module, ref_fn, ref_help = ref_main.COMMANDS[name]
        assert module == ref_module.replace("seaweedfs_tpu.", "seaweedfs_tpu_torch.", 1)
        assert (fn, help_line) == (ref_fn, ref_help)


def test_unknown_verb_is_2(capsys):
    assert port_main.main(["nosuchverb"]) == ref_main.main(["nosuchverb"]) == 2


def test_version_equals_reference(capsys):
    out = stdout_of(capsys, port_main, ["version"])
    assert out == stdout_of(capsys, ref_main, ["version"]) == "seaweedfs-tpu 0.1.0\n"


@pytest.mark.parametrize("name", sorted(ref_scaffold.TEMPLATES))
def test_scaffold_output_equals_reference(capsys, name):
    out = stdout_of(capsys, port_main, ["scaffold", "-config", name])
    assert out.encode() == stdout_of(capsys, ref_main,
                                     ["scaffold", "-config", name]).encode()


class _Parser(Exception):
    pass


def parser_of(main_mod, verb, monkeypatch) -> argparse.ArgumentParser:
    """The verb's parser, caught at its parse_args before the verb runs."""
    import importlib

    module, fn, _ = main_mod.COMMANDS[verb]

    def grab(self, args=None, namespace=None):
        raise _Parser(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        try:
            getattr(importlib.import_module(module), fn)([])
        except _Parser as got:
            return got.args[0]
    raise AssertionError(f"{verb}: no argparse parser")


def flags(parser) -> dict:
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        key = tuple(a.option_strings) or (a.dest,)
        out[key] = (a.dest, a.default, a.const, a.nargs, a.required,
                    tuple(a.choices) if a.choices else None,
                    getattr(a.type, "__name__", a.type), type(a).__name__)
    return out


# `shell` reads -master/-filer by hand and `version` takes no flags
ARGPARSE_VERBS = sorted(set(ref_main.COMMANDS) - {"shell", "version"})


@pytest.mark.parametrize("verb", ARGPARSE_VERBS)
def test_verb_flags_equal_reference(verb, monkeypatch):
    port = flags(parser_of(port_main, verb, monkeypatch))
    ref = flags(parser_of(ref_main, verb, monkeypatch))
    if verb in DEVICE_VERBS:
        dev = port.pop(("-device",))
        assert dev[0] == "device" and dev[1] is None
        assert dev[5] == ("cuda", "cpu")
    assert port == ref


def test_device_help_says_there_is_no_fallback(monkeypatch):
    for verb in DEVICE_VERBS:
        p = parser_of(port_main, verb, monkeypatch)
        (act,) = [a for a in p._actions if a.option_strings == ["-device"]]
        assert "cuda" in act.help and "-device cpu" in act.help
        assert "no CPU fallback" in act.help


def test_shell_verb_flags_equal_reference(monkeypatch):
    """`shell` takes -master and -filer by hand in both packages: the same
    arguments reach `run_shell` (its commands come from the argv)."""
    import seaweedfs_tpu.shell.shell as ref_shell
    from seaweedfs_tpu_torch.shell import shell as port_shell

    seen = []
    for mod in (port_shell, ref_shell):
        monkeypatch.setattr(mod, "run_shell",
                            lambda *a, **k: seen.append((a, k)) or 0)
    argv = ["shell", "-master", "m:9333", "-filer", "f:8888", "volume.list"]
    assert port_main.main(argv) == ref_main.main(argv) == 0
    assert seen[0] == seen[1]
