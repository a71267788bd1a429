"""Utilities: the undersampling mask (``imaging.create_rn_mask``)."""

from .imaging import create_rn_mask

__all__ = ["create_rn_mask"]
