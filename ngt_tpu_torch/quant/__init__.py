"""Quantization: the quantized-graph search route (``qgraph``)."""
