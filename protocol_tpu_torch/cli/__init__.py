"""Command-line front end of the port (``python -m protocol_tpu_torch.cli``)."""

from .main import build_parser, main

__all__ = ["build_parser", "main"]
