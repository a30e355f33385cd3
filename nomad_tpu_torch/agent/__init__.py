"""Agent: the server and the HTTP /v1 API (a copy of ``nomad_tpu/agent/``;
reference: command/agent/).  The port's agent runs no client."""

from .agent import Agent
from .config import (AgentConfig, ClientBlock, Ports, ServerBlock,
                     load_config_file, parse_config)
from .http import HTTPServer

__all__ = ["Agent", "AgentConfig", "ClientBlock", "Ports", "ServerBlock",
           "load_config_file", "parse_config", "HTTPServer"]
