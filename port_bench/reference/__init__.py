"""A plain NumPy model of the QVZ2 encode, the yardstick that decides a
run's `correct`. It imports nothing of the program: from the quality
text and the configuration it works out the clusters, the statistics,
the codebooks, the dither draws, the quantized symbols and the
container's bytes again (``qvz2.py``)."""
