"""CLI (a copy of ``nomad_tpu/cli/``; reference: command/ package +
main.go)."""

from .commands import build_parser, main

__all__ = ["build_parser", "main"]
