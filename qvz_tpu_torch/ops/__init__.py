"""Device operations: quantize (K1), lane coder (K2), statistics (K3),
k-means (K4), lane decoder (K5)."""
