"""Retrieval bank."""

from .bank import GeoBank, dequantize_values, quantize_values

__all__ = ["GeoBank", "dequantize_values", "quantize_values"]
