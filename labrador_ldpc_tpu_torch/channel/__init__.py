"""Decoder registry, channel models, trial steps and the waterfall sweep."""

from .awgn import ChannelStats, make_two_stage_decoder, noise_sigma, resolve_impl
from .waterfall import SnrPoint, waterfall

__all__ = ["ChannelStats", "SnrPoint", "make_two_stage_decoder", "noise_sigma", "resolve_impl",
           "waterfall"]
