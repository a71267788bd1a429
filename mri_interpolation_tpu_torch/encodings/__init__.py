"""Coordinate encodings."""

from .fourier import GaussianFourierEncoding
from .frequency import FrequencyEncoding
from .hashgrid import PRIMES, HashGridEncoding, spatial_hash

__all__ = ["HashGridEncoding", "PRIMES", "spatial_hash", "FrequencyEncoding", "GaussianFourierEncoding"]
