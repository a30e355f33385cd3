"""HCL job-file parsing (a copy of ``nomad_tpu/jobspec/``; reference:
jobspec/ package)."""

from .hcl import Block, Entry, HCLError, parse_hcl
from .parse import ParseError, parse, parse_duration, parse_file

__all__ = ["Block", "Entry", "HCLError", "parse_hcl", "ParseError", "parse",
           "parse_duration", "parse_file"]
