"""Quantization: k-means (``clustering``), product quantization (``pq``),
the quantized-graph search route (``qgraph``) and the IVFPQ index
(``ivfpq``)."""
