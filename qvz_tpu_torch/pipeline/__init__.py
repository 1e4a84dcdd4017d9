"""The device QVZ2 encode and decode pipelines."""
