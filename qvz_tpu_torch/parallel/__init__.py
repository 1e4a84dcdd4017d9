"""Drivers that run the encode and decode across processes."""
