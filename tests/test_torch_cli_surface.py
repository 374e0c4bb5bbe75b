"""The port's CLI surface against JAX's: tests/test_cli_surface.py's
argparse probe (it needs no /root/reference) run on `kaldi_tpu.cli.main`
and `kaldi_tpu_torch.cli.main`. The port's subcommands and aliases are
JAX's, all of them: the list of what the port still lacks is empty (the
first CLI slice took 78 subcommands and 5 aliases off it, the second 97
and 19, the third 75 and 9, the fourth 92 and 16, the fifth 49 and 3
(5a) and 65 and 28 (5b)).
"""

import argparse
import importlib

import pytest

NOT_YET_PORTED: set = set()


def _commands(module: str) -> tuple[set, set]:
    """-> (subcommands, aliases) that `module`.main registers."""
    cli = importlib.import_module(module)
    return set(_parsers(module)), set(getattr(cli, "_ALIASES", {}))


def test_port_cli_is_a_subset_of_jax_and_the_rest_is_listed():
    js, ja = _commands("kaldi_tpu.cli")
    ts, ta = _commands("kaldi_tpu_torch.cli")
    assert ts <= js and ta <= ja, sorted((ts - js) | (ta - ja))
    assert (js | ja) - (ts | ta) == NOT_YET_PORTED
    assert len(NOT_YET_PORTED & js) == 0 and len(NOT_YET_PORTED & ja) == 0
    assert ts == js and ta == ja


def _parsers(module: str) -> dict:
    """-> {subcommand: its argparse parser} that `module`.main builds."""
    if module not in _PARSERS:
        cli = importlib.import_module(module)
        captured = {}
        orig = argparse.ArgumentParser.parse_args

        def spy(self, args=None, namespace=None):
            captured["p"] = self
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = spy
        try:
            cli.main(["__probe__"])
        except SystemExit:
            pass
        finally:
            argparse.ArgumentParser.parse_args = orig
        sub = next(a for a in captured["p"]._actions
                   if isinstance(a, argparse._SubParsersAction))
        _PARSERS[module] = dict(sub.choices)
    return _PARSERS[module]


_PARSERS: dict = {}


def _arguments(parser) -> list:
    """A parser's arguments as (flags, dest, default, nargs, required,
    choices, const, type name), without `--help` and the port's
    `--device`."""
    return [(tuple(a.option_strings), a.dest, a.default, a.nargs,
             a.required, a.choices, a.const,
             getattr(a.type, "__name__", None))
            for a in parser._actions
            if a.dest not in ("help", "device")]


@pytest.mark.parametrize("name", sorted(_parsers("kaldi_tpu_torch.cli")))
def test_port_subcommand_takes_jax_arguments(name):
    """Every ported subcommand takes JAX's argument names, defaults,
    arities and choices; the port adds only `--device`."""
    port = _parsers("kaldi_tpu_torch.cli")[name]
    assert _arguments(port) == _arguments(_parsers("kaldi_tpu.cli")[name])
    dev = [a for a in port._actions if a.dest == "device"]
    assert all(a.default == "cuda" for a in dev), name
