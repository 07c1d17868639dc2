"""Decoder registry of the port (channel models come with a later slice)."""

from .awgn import resolve_impl

__all__ = ["resolve_impl"]
