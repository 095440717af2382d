"""The JAX package's campaigns (tools/round*_*.sh, tools/round4_task5.py),
checked against the port: every command they run has a counterpart in the
port that accepts its flags.

Each script's commands are read as the shell would: backslash
continuations joined, the script's own variables (``E=64; H=128;
NAME=cap2x``, ``OUT=...${NAME}``) substituted, a heredoc's body kept with
its command, ``VAR=value`` prefixes split off as the command's environment,
redirections and subshell parentheses dropped. Then:

* ``python -m ai_font_renderer_tpu.cli train-placement ...`` and ``python
  tools/train_placement.py ...`` parse under the port's
  ``train/placement_cli.py:add_args``;
* ``python tools/<name>.py`` has ``ai_font_renderer_tpu_torch/tools/<name>.py``
  (``ab_profiles``' profile names are the port's);
* ``python model.py ...`` parses under the port's bare run
  (``python -m ai_font_renderer_tpu_torch``);
* ``python -`` with a heredoc that runs ``__graft_entry__``'s dry run maps to
  the port's ``tools/dryrun_multichip.py``;
* every environment variable a command is given that the JAX package reads
  (``AFR_DUMP_AFTER``) is read by the port;
* ``python bench.py`` is the one exception: the port's benchmark is a later
  piece of work.
"""

import argparse
import ast
import glob
import os
import re
import shlex

import pytest

from ai_font_renderer_tpu_torch import cli
from ai_font_renderer_tpu_torch.tools import ab_profiles, round4_task5
from ai_font_renderer_tpu_torch.train import placement_cli

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SCRIPTS = sorted(glob.glob(os.path.join(ROOT, "tools", "round*_*.sh")))
EXCEPTIONS = {"bench.py"}
_ASSIGN = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*=")


def _substitute(text: str, env: dict) -> str:
    return re.sub(r"\$\{(\w+)\}|\$(\w+)", lambda m: env.get(m.group(1) or m.group(2), m.group(0)), text)


def commands(path: str) -> list[dict]:
    """The python commands of one campaign script: {"argv", "env",
    "heredoc", "line"}."""
    with open(path) as f:
        lines = f.read().replace("\\\n", " ").splitlines()
    env: dict = {}
    out = []
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        heredoc = None
        m = re.search(r"<<-?\s*'?(\w+)'?", line)
        if m:
            body = []
            while i < len(lines) and lines[i].strip() != m.group(1):
                body.append(lines[i])
                i += 1
            i += 1
            heredoc = "\n".join(body)
            line = line[: m.start()]
        for part in re.split(r"\s*(?:;|&&)\s*", line):
            part = part.strip().strip("()").strip()
            words = shlex.split(_substitute(part, env), comments=True) if part else []
            if words and all(_ASSIGN.match(w) for w in words):  # the script's own variables
                for w in words:
                    name, _, value = w.partition("=")
                    if "$(" not in value:
                        env[name] = value
                continue
            prefix = {}
            while words and _ASSIGN.match(words[0]):
                name, _, value = words.pop(0).partition("=")
                prefix[name] = value
            if not words or words[0] not in ("python", "python3"):
                continue
            argv = []
            skip = False
            for w in words[1:]:
                if skip:
                    skip = False
                    continue
                if w in (">", ">>", "2>", "1>"):
                    skip = True
                    continue
                if w.startswith((">", "2>", "1>")) or w == "&":
                    continue
                argv.append(w)
            out.append({"argv": argv, "env": prefix, "heredoc": heredoc, "line": f"{os.path.basename(path)}: {part}"})
    return out


ALL = [c for path in SCRIPTS for c in commands(path)]


def _kind(cmd: dict) -> str:
    argv = cmd["argv"]
    if argv[:3] == ["-m", "ai_font_renderer_tpu.cli", "train-placement"] or argv[0] == "tools/train_placement.py":
        return "train-placement"
    if argv[0] == "-":
        return "heredoc"
    base = os.path.basename(argv[0])
    if base == "model.py":
        return "model.py"
    if base in EXCEPTIONS:
        return "exception"
    if argv[0].startswith("tools/") and argv[0].endswith(".py"):
        return "tool"
    return "unknown"


def _strict(parser: argparse.ArgumentParser, argv: list[str]):
    """parse_args, a refusal raised as a test failure with its message."""

    def refuse(message):
        raise AssertionError(message)

    parser.error = refuse
    return parser.parse_args(argv)


def test_every_campaign_script_is_read():
    assert len(SCRIPTS) == 44
    kinds = [_kind(c) for c in ALL]
    assert "unknown" not in kinds, [c["line"] for c in ALL if _kind(c) == "unknown"]
    # tools/round*_*.sh as the JAX package has them: 31 train_placement.py
    # calls and 34 of the CLI's train-placement, among the rest.
    assert kinds.count("train-placement") == 65
    assert kinds.count("model.py") == 6 and kinds.count("exception") == 3 and kinds.count("heredoc") == 1


@pytest.mark.parametrize("script", [os.path.basename(p) for p in SCRIPTS])
def test_each_command_has_a_port_counterpart(script):
    for cmd in commands(os.path.join(ROOT, "tools", script)):
        kind, argv = _kind(cmd), cmd["argv"]
        if kind == "train-placement":
            ap = argparse.ArgumentParser()
            placement_cli.add_args(ap)
            args = _strict(ap, argv[3:] if argv[0] == "-m" else argv[1:])
            assert args.kernels == "none" and args.device == "cuda", cmd["line"]
        elif kind == "model.py":
            args = _strict(cli._train_parser(), argv[1:])
            assert args.train, cmd["line"]
        elif kind == "tool":
            name = os.path.basename(argv[0])[:-3]
            assert os.path.exists(os.path.join(ROOT, "ai_font_renderer_tpu_torch", "tools", f"{name}.py")), cmd["line"]
            if name == "ab_profiles":
                assert set(argv[1:]) <= set(ab_profiles.PROFILES), cmd["line"]
        elif kind == "heredoc":
            assert "import __graft_entry__" in cmd["heredoc"] and "dryrun_multichip" in cmd["heredoc"]
            assert os.path.exists(os.path.join(ROOT, "ai_font_renderer_tpu_torch", "tools", "dryrun_multichip.py"))
        else:
            assert kind == "exception" and os.path.basename(argv[0]) in EXCEPTIONS, cmd["line"]


def _reads(package: str, name: str) -> bool:
    for path in glob.glob(os.path.join(ROOT, package, "**", "*.py"), recursive=True):
        with open(path) as f:
            if f'"{name}"' in f.read():
                return True
    return False


def test_every_environment_variable_the_jax_package_reads_is_read_by_the_port():
    given = {name for c in ALL for name in c["env"]}
    assert "AFR_DUMP_AFTER" in given
    read_by_jax = {name for name in given if _reads("ai_font_renderer_tpu", name)}
    assert read_by_jax == {"AFR_DUMP_AFTER"}
    assert all(_reads("ai_font_renderer_tpu_torch", name) for name in read_by_jax)


def test_round4_task5_runs_the_same_profiles():
    """tools/round4_task5.py's ab_profiles argv and traced profiles are the
    port's round4_task5.AB and TRACED, and every one is a port profile."""
    with open(os.path.join(ROOT, "tools", "round4_task5.py")) as f:
        tree = ast.parse(f.read())
    argv = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                if isinstance(n, ast.Assign) and ast.unparse(n.targets[0]) == "sys.argv")
    traced = next(ast.literal_eval(n.iter) for n in ast.walk(tree) if isinstance(n, ast.For))
    assert tuple(argv[1:]) == round4_task5.AB and traced == round4_task5.TRACED
    assert set(round4_task5.AB) <= set(ab_profiles.PROFILES)
