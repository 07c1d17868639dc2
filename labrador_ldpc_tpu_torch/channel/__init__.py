"""Decoder registry, channel models, trial steps and the waterfall sweep."""

from .awgn import ChannelStats, noise_sigma, resolve_impl
from .waterfall import SnrPoint, waterfall

__all__ = ["ChannelStats", "SnrPoint", "noise_sigma", "resolve_impl", "waterfall"]
