"""Coordinate encodings."""

from .hashgrid import PRIMES, HashGridEncoding

__all__ = ["HashGridEncoding", "PRIMES"]
