"""Coordinate encodings."""

from .fourier import GaussianFourierEncoding
from .frequency import FrequencyEncoding
from .hashgrid import PRIMES, HashGridEncoding

__all__ = ["HashGridEncoding", "PRIMES", "FrequencyEncoding", "GaussianFourierEncoding"]
